"""The in-process backend: the threaded multi-rank world (the port's copy
of the JAX package's ``repro.core.comm.inproc``).

Behavior-identical to the pre-registry transport (and still the default):
one heap inbox per rank with injectable delivery delay/reorder, and — via
:class:`~repro_torch.core.faults.FaultPlan` — seeded message loss, duplication,
and rank kills, so the completion protocol is stress-tested adversarially
without leaving the process.

Also provides the loopback :class:`InProcListener` / :class:`InProcComm`
channel pair (Dask's ``inproc://`` analogue) so the transport conformance
suite exercises the channel contract itself, not only the world built on
top of it.
"""

from __future__ import annotations

import heapq
import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..faults import FaultPlan, RecoveryReport
from .core import (Backend, Comm, CommClosedError, Connector, Listener,
                   Wire)


class InProcWorld:
    """Per-rank inboxes + adversarial delivery (delay / reorder / loss /
    duplication / rank death). Wires pass by reference, so a tensor payload
    stays on its device (``carries_device_tensors``)."""

    carries_device_tensors = True

    def __init__(self, n_ranks: int,
                 delay_fn: Optional[Callable[..., float]] = None,
                 faults: Optional[FaultPlan] = None):
        self.n_ranks = n_ranks
        self.delay_fn = delay_fn
        self.faults = faults
        self.report = RecoveryReport()
        # Set when any rank *fails* (exception): every other rank aborts
        # instead of waiting forever inside the completion protocol.
        self.poison = threading.Event()
        self._locks = [threading.Lock() for _ in range(n_ranks)]
        # Each inbox is a heap of (deliver_at, seq, wire).
        self._inboxes: List[list] = [[] for _ in range(n_ranks)]
        self._seq = itertools.count()
        self._fingerprints: List[list] = [[] for _ in range(n_ranks)]
        # Fault machinery: killed ranks, per-rank user-AM send counts (kill
        # triggers), per-edge RNG streams, per-rank shutdown flags (the
        # post-SHUTDOWN ack linger; see Communicator.run_until_shutdown).
        self.dead: set = set()
        self._fault_lock = threading.Lock()
        self._user_sent = [0] * n_ranks
        self._edge_rng: Dict[tuple, Any] = {}
        self._shutdown_flags = [False] * n_ranks
        # rank -> zero-arg callable returning that rank's forensic state
        self._snapshots: List[Optional[Callable]] = [None] * n_ranks

    # ----------------------------------------------------------- fault hooks

    def check_dead_or_kill(self, src: int) -> bool:
        """Called once per *user AM first-send* from ``src``; counts it
        against the kill plan. True => the rank is (now) dead and the send
        must be abandoned."""
        if src in self.dead:
            return True
        f = self.faults
        if f is None or src not in f.kill:
            return False
        with self._fault_lock:
            self._user_sent[src] += 1
            fire = self._user_sent[src] >= f.kill[src] and src not in self.dead
        if fire:
            self.kill(src)
        return src in self.dead

    def kill(self, rank: int) -> None:
        """Physically silence ``rank``: no message from it is ever delivered
        again, its inbox is discarded, undelivered messages it already sent
        are purged. Idempotent; safe from any thread."""
        with self._fault_lock:
            if rank in self.dead:
                return
            self.dead.add(rank)
        for r in range(self.n_ranks):
            with self._locks[r]:
                if r == rank:
                    self._inboxes[r].clear()
                else:
                    kept = [item for item in self._inboxes[r]
                            if item[2].src != rank]
                    if len(kept) != len(self._inboxes[r]):
                        heapq.heapify(kept)
                        self._inboxes[r] = kept
        # a dead rank cannot object to shutdown
        self._shutdown_flags[rank] = True

    def flag_shutdown(self, rank: int) -> None:
        self._shutdown_flags[rank] = True

    def all_shutdown(self) -> bool:
        return all(self._shutdown_flags)

    # ------------------------------------------------------------- transport

    def send(self, dst: int, wire: Wire) -> None:
        if wire.src in self.dead or dst in self.dead:
            return  # crashed endpoints: silently fenced
        duplicate = False
        f = self.faults
        if f is not None and (f.drop or f.duplicate):
            with self._fault_lock:
                rng = self._edge_rng.get((wire.src, dst))
                if rng is None:
                    rng = self._edge_rng[(wire.src, dst)] = f.edge_rng(
                        wire.src, dst)
                # always draw both so the stream stays aligned per edge
                dropped = rng.random() < f.drop
                duplicate = rng.random() < f.duplicate
            if dropped:
                self.report.bump("injected_drops")
                return
            if duplicate:
                self.report.bump("injected_dups")
        self._deliver(dst, wire)
        if duplicate:
            self._deliver(dst, wire)

    def _deliver(self, dst: int, wire: Wire) -> None:
        delay = self.delay_fn(wire.src, dst, wire.kind) if self.delay_fn \
            else 0.0
        deliver_at = time.monotonic() + delay
        with self._locks[dst]:
            heapq.heappush(self._inboxes[dst],
                           (deliver_at, next(self._seq), wire))

    def poll(self, rank: int) -> List[Wire]:
        """Pop every message whose delivery time has arrived."""
        now = time.monotonic()
        out: List[Wire] = []
        with self._locks[rank]:
            inbox = self._inboxes[rank]
            while inbox and inbox[0][0] <= now:
                out.append(heapq.heappop(inbox)[2])
        return out

    def has_traffic(self, rank: int) -> bool:
        with self._locks[rank]:
            return bool(self._inboxes[rank])

    def register_fingerprint(self, rank: int, fp: str) -> int:
        """Record AM registration order; verify global consistency (§II-B2)."""
        fps = self._fingerprints[rank]
        am_id = len(fps)
        fps.append(fp)
        for other in range(self.n_ranks):
            others = self._fingerprints[other]
            if len(others) > am_id and others[am_id] != fp:
                raise RuntimeError(
                    f"active messages registered in different orders: rank {rank} "
                    f"registered {fp!r} as id {am_id}, rank {other} has {others[am_id]!r}"
                )
        return am_id

    # ------------------------------------------------------------- forensics

    def attach_snapshot_provider(self, rank: int, fn: Callable) -> None:
        """Register the callable serving ``rank``'s forensic snapshot
        (later registrations win: the scheduler's ShardRuntime overrides
        the bare communicator snapshot with its richer serve-loop state)."""
        self._snapshots[rank] = fn

    def snapshot_rank(self, rank: int):
        fn = self._snapshots[rank]
        if fn is None:
            return None
        try:
            return fn()
        except Exception as e:  # forensics must never mask the real error
            return f"<snapshot failed: {e!r}>"


# ------------------------------------------------------- loopback channels


class InProcComm(Comm):
    """One end of an in-process duplex channel (a queue pair)."""

    def __init__(self, rx: "queue.Queue", tx: "queue.Queue",
                 peer_closed: threading.Event, self_closed: threading.Event):
        self._rx = rx
        self._tx = tx
        self._peer_closed = peer_closed
        self._self_closed = self_closed

    def write(self, msg) -> None:
        if self._self_closed.is_set() or self._peer_closed.is_set():
            raise CommClosedError("inproc comm is closed")
        self._tx.put(msg)

    def read(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self._rx.get(timeout=0.05)
            except queue.Empty:
                if self._peer_closed.is_set() and self._rx.empty():
                    raise CommClosedError("peer closed") from None
                if self._self_closed.is_set():
                    raise CommClosedError("comm closed") from None
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError("inproc read timed out") from None

    def close(self) -> None:
        self._self_closed.set()

    @property
    def closed(self) -> bool:
        return self._self_closed.is_set()


_LISTENERS: Dict[str, "InProcListener"] = {}
_LISTENER_LOCK = threading.Lock()
_ADDR = itertools.count()


class InProcListener(Listener):
    """Loopback listener: connects land as queue pairs, the handler runs
    on a dedicated thread per accepted channel."""

    def __init__(self, handler):
        super().__init__(handler)
        self.address = f"inproc://{next(_ADDR)}"
        self._stopped = threading.Event()

    def start(self) -> None:
        with _LISTENER_LOCK:
            _LISTENERS[self.address] = self

    def stop(self) -> None:
        self._stopped.set()
        with _LISTENER_LOCK:
            _LISTENERS.pop(self.address, None)

    def _accept(self) -> Comm:
        if self._stopped.is_set():
            raise CommClosedError(f"listener {self.address} is stopped")
        a2b: queue.Queue = queue.Queue()
        b2a: queue.Queue = queue.Queue()
        ca, cb = threading.Event(), threading.Event()
        server = InProcComm(a2b, b2a, peer_closed=cb, self_closed=ca)
        client = InProcComm(b2a, a2b, peer_closed=ca, self_closed=cb)
        threading.Thread(target=self.handler, args=(server,),
                         daemon=True).start()
        return client


class InProcConnector(Connector):
    def connect(self, address: str, timeout: float = 5.0) -> Comm:
        with _LISTENER_LOCK:
            listener = _LISTENERS.get(address)
        if listener is None:
            raise CommClosedError(f"no inproc listener at {address}")
        return listener._accept()


# ------------------------------------------------------------- the backend


class InProcBackend(Backend):
    """Threaded rank emulation: the pre-registry ``run_ranks`` semantics,
    verbatim (poison propagation, root-cause surfacing, resident
    scheduler mode, timeout forensics)."""

    def listener(self, handler) -> Listener:
        return InProcListener(handler)

    def connector(self) -> Connector:
        return InProcConnector()

    def run_ranks(self, n_ranks: int, main, *, n_threads: int = 2,
                  delay_fn=None, faults=None, timeout: float = 120.0,
                  serve_scheduler=None):
        from .. import runtime as rt

        world = InProcWorld(n_ranks, delay_fn=delay_fn, faults=faults)
        if serve_scheduler is not None:
            # the resident service needs the world for recovery gating (is
            # a fault plan active?), the dead set, and future-timeout
            # forensics
            serve_scheduler.attach_world(world)
        results = [None] * n_ranks
        errors: list = []

        def runner(rank: int) -> None:
            status, payload = rt.rank_session(world, rank, main, n_threads)
            if status == "ok":
                results[rank] = payload
            elif status == "error":
                errors.append((rank, payload))

        threads = [
            threading.Thread(target=runner, args=(r,), daemon=True,
                             name=f"rank{r}")
            for r in range(n_ranks)
        ]
        for t in threads:
            t.start()
        if serve_scheduler is not None:
            while not serve_scheduler.draining.wait(timeout=0.25):
                if world.poison.is_set() or errors:
                    break   # a rank died while serving: fall through, join
        deadline = time.monotonic() + timeout
        stuck = []
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                stuck.append(int(t.name.replace("rank", "")))
        if stuck:
            world.poison.set()  # let salvageable ranks unwind first
            raise TimeoutError(rt.timeout_forensics(stuck, world, timeout))
        if errors:
            rank, err = errors[0]
            raise RuntimeError(
                f"rank {rank} failed:\n{rt.format_rank_error(err)}") from err
        if faults is not None:
            return results, world.report
        return results
