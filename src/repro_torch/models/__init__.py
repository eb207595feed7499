"""The LM stack of the port (counterpart of ``repro.models``): ``config``
(``ModelConfig``), ``layers`` (attention, FFN), ``rglru``, ``xlstm``,
``moe``, ``sharding`` (the one-card subset) and ``model`` (``LM``,
``init_params``, ``forward``, ``init_cache``, ``decode_step`` and the
weights carried across from the reference)."""
