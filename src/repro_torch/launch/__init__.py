"""Launchers of the port (``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.scheduler``) and the environment flags the ported
modules read."""

__all__ = ["flags", "scheduler", "serve", "train"]
