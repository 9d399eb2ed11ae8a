"""Pluggable active-message transport: interfaces + backend registry (the
port's copy of the JAX package's ``repro.core.comm.core``).

The host runtime above this package is transport-agnostic by construction
(reliable delivery, completion detection, and DEATH/epoch recovery all
speak the :class:`World` contract below) — this module makes the transport
itself pluggable, shaped after Dask Distributed's ``distributed/comm``:

- :class:`Comm` — one established duplex point-to-point channel;
- :class:`Listener` — accepts inbound channels at an address;
- :class:`Connector` — opens an outbound channel to an address;
- :class:`Backend` — a named bundle of the three plus the rank launcher
  (``run_ranks``) that runs SPMD mains over that transport.

Backends register under a name (``register_backend``) and are selected by
``run_ranks(..., transport=...)`` / ``SchedulerService(transport=...)``:

========== ============================================================
backend    world
========== ============================================================
inproc     one process, one thread-group per rank, heap inboxes — the
           default for tests; supports delay/reorder/loss/dup/kill
           injection (:mod:`repro_torch.core.comm.inproc`)
multiproc  one OS process per rank, length-prefixed cloudpickle frames
           over loopback TCP sockets, parent-process rendezvous — the
           same runtime messages (reliable delivery, fault injection,
           DEATH/epoch recovery) over a real remote transport
           (:mod:`repro_torch.core.comm.multiproc`)
========== ============================================================

The **world contract** every backend's world satisfies (the transport
surface :class:`~repro_torch.core.messages.Communicator`,
:class:`~repro_torch.core.completion.CompletionDetector`, and a resident
scheduler's shard runtime program against):

- attributes: ``n_ranks``, ``faults``, ``report`` (a
  :class:`~repro_torch.core.faults.RecoveryReport`), ``poison`` (Event-like:
  ``is_set``/``set``), ``dead`` (set of fenced ranks),
  ``carries_device_tensors`` (True when a wire's tensors may stay on their
  device, as in one process; False when wires are pickled across
  processes, which takes host tensors only);
- transport: ``send(dst, wire)`` (thread-safe, lossy under a FaultPlan),
  ``poll(rank)`` (drain due messages), ``has_traffic(rank)``;
- membership: ``kill(rank)`` (idempotent physical fence),
  ``check_dead_or_kill(src)`` (user-AM send counting against the kill
  plan), ``flag_shutdown(rank)`` / ``all_shutdown()`` (the post-SHUTDOWN
  ack linger), ``register_fingerprint(rank, fp)`` (global AM identity);
- forensics: ``attach_snapshot_provider(rank, fn)`` /
  ``snapshot_rank(rank)`` — how timeout diagnostics reach a rank's
  protocol state without assuming shared memory (a multiproc snapshot is
  served by the rank's process over its control channel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch


@dataclass
class Wire:
    """One message on the wire — the unit every backend carries.

    ``kind`` is ``"am"`` / ``"large_am"`` for user traffic, a completion-
    protocol kind (COUNT/REQUEST/CONFIRMATION/SHUTDOWN/DEATH), or a
    transport kind (ACK/HB). ``seq`` is the reliable-stream sequence per
    ``(src, dst)``; ``-1`` rides the raw (unsequenced) wire. ``blob`` holds
    the pickled plain arguments; every tensor argument travels beside it in
    ``tensors`` (an on-device copy made at send), never inside the pickle.
    """

    kind: str          # "am" | "large_am" | protocol kinds | ACK | HB
    src: int
    am_id: int = -1
    blob: bytes = b""          # pickled plain args (tensors left out)
    raw: Optional[torch.Tensor] = None  # large-AM view payload (no copy)
    meta: Any = None           # protocol payload
    seq: int = -1              # reliable-stream seq per (src, dst); -1 = raw
    tensors: tuple = ()        # the args' tensors, by their pickle slot


class CommClosedError(RuntimeError):
    """The channel (or its listener) was closed under the operation."""


class Comm:
    """One established duplex channel between two endpoints.

    ``write`` enqueues one message (any picklable object; backends may
    pass it by reference in-process); ``read`` blocks up to ``timeout``
    for the next message and raises :class:`CommClosedError` once the
    peer closed and the buffer drained. Both ends see FIFO order.
    """

    def write(self, msg) -> None:
        raise NotImplementedError

    def read(self, timeout: Optional[float] = None):
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        raise NotImplementedError


class Listener:
    """Accepts inbound channels at ``address``; each accepted
    :class:`Comm` is handed to ``handler`` (on an internal thread).
    ``stop()`` is idempotent and releases the address — a clean shutdown
    must leave later ``connect`` attempts failing fast, not hanging."""

    address: str

    def __init__(self, handler: Callable[[Comm], None]):
        self.handler = handler

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError


class Connector:
    """Opens an outbound :class:`Comm` to a listener's address."""

    def connect(self, address: str, timeout: float = 5.0) -> Comm:
        raise NotImplementedError


class Backend:
    """One registered transport backend."""

    name: str = "?"
    carries_device_tensors: bool = True

    def listener(self, handler: Callable[[Comm], None]) -> Listener:
        raise NotImplementedError

    def connector(self) -> Connector:
        raise NotImplementedError

    def run_ranks(self, n_ranks: int, main, *, n_threads: int = 2,
                  delay_fn=None, faults=None, timeout: float = 120.0,
                  serve_scheduler=None):
        """SPMD-launch ``main`` over this transport; the contract of
        :func:`repro_torch.core.runtime.run_ranks`."""
        raise NotImplementedError


_REGISTRY: Dict[str, Backend] = {}


def register_backend(name: str, backend: Backend) -> None:
    backend.name = name
    _REGISTRY[name] = backend


def get_backend(name: Optional[str] = None) -> Backend:
    """Resolve a backend by name (default: ``$REPRO_TRANSPORT`` or
    ``inproc``). Unknown names fail loudly with the registered set."""
    import os

    if name is None:
        name = os.environ.get("REPRO_TRANSPORT", "inproc")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown transport backend {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def backend_names():
    return sorted(_REGISTRY)
