"""Launchers of the port (``python -m repro_torch.launch.serve``) and the
environment flags the ported modules read."""
