"""The LM stack of the port (counterpart of ``repro.models``): ``config``
(``ModelConfig``), ``layers`` (attention, FFN), ``rglru``, ``xlstm``,
``moe``, ``sharding`` (the mesh rules and the autograd collectives),
``placement`` (a model's blocks on a mesh and back) and ``model``
(``LM``, ``init_params``, ``forward``, ``init_cache``, ``decode_step`` and
the weights carried across from the reference)."""
