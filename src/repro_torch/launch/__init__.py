"""Launchers of the port (counterpart of ``repro.launch``): ``mesh`` and
``serve`` (``python -m repro_torch.launch.serve``)."""
