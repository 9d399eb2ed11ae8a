"""Launchers of the port (``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.scheduler``, ``python -m repro_torch.launch.dryrun``),
the logical meshes they run under (``mesh``), the meta-device inputs of
every step (``specs``) and the environment flags the ported modules
read."""

__all__ = ["dryrun", "flags", "mesh", "scheduler", "serve", "specs", "train"]
