"""Launchers of the port (counterpart of ``repro.launch``): ``mesh``,
``serve`` (``python -m repro_torch.launch.serve``) and ``train``
(``python -m repro_torch.launch.train``)."""
