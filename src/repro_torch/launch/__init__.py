"""Launchers of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.scheduler``) and the environment flags the
ported modules read."""
