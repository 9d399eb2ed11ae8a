"""Pluggable active-message transports (see
:mod:`repro_torch.core.comm.core`).

Importing this package registers the built-in backends:

- ``inproc``    — threaded ranks in this process (the default);
- ``multiproc`` — one forked OS process per rank over loopback TCP.
"""

from .core import (Backend, Comm, CommClosedError, Connector, Listener,
                   Wire, backend_names, get_backend, register_backend)
from .inproc import InProcBackend, InProcWorld
from .multiproc import MultiProcBackend, MultiProcWorld

register_backend("inproc", InProcBackend())
register_backend("multiproc", MultiProcBackend())

__all__ = [
    "Backend", "Comm", "CommClosedError", "Connector", "Listener", "Wire",
    "backend_names", "get_backend", "register_backend",
    "InProcBackend", "InProcWorld", "MultiProcBackend", "MultiProcWorld",
]
