"""One-sided active messages (§II-A2) over an in-process multi-rank world
(the port's copy of the JAX package's ``repro.core.messages``, with a data
plane that keeps tensor payloads on their device).

An **active message** (AM) is a pair ``(function, payload)``: sent from rank
*a* to rank *b*, the payload travels the network and on arrival the function
runs on *b* with the payload as arguments — the receiver never waits.

Semantics kept faithful to the paper:

- ``make_active_msg`` must be called in the *same order on every rank*; the
  registration index is the globally-consistent AM id used to look the
  function up on the receiver (§II-B2).
- ``send`` serializes the payload into a temporary buffer immediately, so
  caller arguments are reusable the moment ``send`` returns; it is
  thread-safe (any worker may send).
- **Large AMs** skip the temporary copy: the payload contains one
  :class:`view` sent "directly" plus regular args, with the three-callback
  contract — receiver-side buffer allocation, receiver-side processing, and
  a sender-side completion hook that fires when the sender buffer is
  reusable (here: when the transport ack arrives, since the buffer must stay
  live across retransmits).
- The communicator counts *queued* and *processed* user AMs (``q_r``,
  ``p_r``); protocol traffic (completion detection, acks, heartbeats,
  retransmits) is excluded, exactly as required by §II-B3 step 1.

The "network" is any registered comm backend's world (see
:mod:`repro_torch.core.comm`): the default :class:`InProcWorld` keeps one inbox
per rank in-process with injectable per-message delivery delay and
reordering, and — via :class:`~repro_torch.core.faults.FaultPlan` — message
loss, duplication, and rank kills, so the completion protocol can be
stress-tested adversarially; the ``multiproc`` world carries the same
wires between real OS processes over loopback TCP.

On top of the lossy wire the communicator runs a **reliable delivery
layer**: every non-ack message carries a per-``(src, dst)`` sequence number;
the receiver acks each seq (acks themselves are unreliable) and
deduplicates by ``(src, seq)`` with cumulative compaction; the sender keeps
an unacked window per destination and retransmits on an exponential
backoff, marking a destination SUSPECT after the retry budget (retransmits
then continue at the capped interval — only the failure detector may
*declare* a rank dead). Exactly-once accounting survives because ``q_r``
counts a user AM once at first queue and ``p_r`` once at first (post-dedup)
delivery; retransmits and duplicates touch neither counter.

Semantically each rank is one MPI rank; the mapping to a real cluster is
one process per node with the world's queues replaced by
MPI_Isend/Iprobe/Irecv (the paper's transport) — the reliability protocol
is transport-agnostic by construction: everything in this module programs
against the world contract documented in :mod:`repro_torch.core.comm.core`.

**Device-aware payloads** (what differs from the JAX package, whose
payloads are numpy arrays pickled into the serialization buffer):

- plain arguments (keys, block ids, ``None``, numpy arrays) are pickled as
  before; every ``torch.Tensor`` argument, at any depth, is left out of the
  pickle (a persistent id marks its place) and travels beside it in
  ``Wire.tensors`` as ``t.clone()``, made on the sender's current stream.
  That copy is the paper's serialization buffer: the caller's tensor is
  reusable once ``send`` returns, and a CUDA payload never leaves the card;
- a large AM's :class:`view` wraps a tensor, sent without a copy; the
  receiver fills its ``alloc`` buffer with ``copy_`` on the buffer's device;
- a world whose wires cross processes (``carries_device_tensors`` False,
  the ``multiproc`` transport) pickles its frames, tensors included, so it
  takes host tensors only: a CUDA tensor raises ``ValueError`` at ``send``
  and is never moved to the host quietly.

:data:`payload_stats` counts what the AM path did with tensors: copied on
their device, or pickled into a frame, plus user AMs and tensor bytes per
``(src, dst)`` pair (all ranks of this process).

Ordering on the card: a payload's clone is enqueued on the sender's stream
after the kernels that produced it, and the receiver's consumers are
launched later on the same stream, so the stream carries the dependence.
This holds while every body runs on one stream (the default).
"""

from __future__ import annotations

import io
import itertools
import pickle
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from .comm import InProcWorld  # noqa: F401  (compat re-export)
from .comm import Wire as _Wire
from .faults import FaultPlan

# Transport-level kinds that are themselves the reliability mechanism and so
# ride the raw (lossy) wire without sequence numbers.
ACK, HEARTBEAT = "ACK", "HB"
_UNRELIABLE_KINDS = (ACK, HEARTBEAT)


class WorldPoisoned(RuntimeError):
    """Another rank failed; this rank aborts its join loop as a *victim*
    (its own work is not the root cause and is not reported as such)."""


class RankKilled(RuntimeError):
    """Raised inside a rank that a :class:`FaultPlan` killed mid-run."""


class view:
    """A (pointer, length) view over a buffer (paper's view<T>): wraps a
    tensor (numpy input is wrapped without a copy)."""

    def __init__(self, array):
        self.array = torch.as_tensor(array)

    def __len__(self) -> int:
        return self.array.numel()


class PayloadStats:
    """Thread-safe tally of the AM path's tensor payloads: ``copied``
    (cloned on their device, never serialized), ``pickled`` (serialized
    into a cross-process frame), and ``pairs`` — ``(src, dst)`` ->
    ``[user AMs, tensor bytes]``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.copied = 0
            self.pickled = 0
            self.pairs: Dict[Tuple[int, int], List[int]] = {}

    def note(self, src: int, dst: int, tensors: Sequence[torch.Tensor],
             pickled: bool) -> None:
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        with self._lock:
            if pickled:
                self.pickled += len(tensors)
            else:
                self.copied += len(tensors)
            pair = self.pairs.setdefault((src, dst), [0, 0])
            pair[0] += 1
            pair[1] += nbytes


payload_stats = PayloadStats()


def on_host(t: torch.Tensor) -> bool:
    """Whether a tensor may ride a pickled (cross-process) frame."""
    return t.device.type == "cpu"


class _TensorPickler(pickle.Pickler):
    """Pickles plain arguments; each tensor met at any depth is replaced by
    its index in ``tensors`` (a persistent id) instead of its bytes."""

    def __init__(self, file, tensors: List[torch.Tensor]):
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self.tensors = tensors

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            self.tensors.append(obj)
            return len(self.tensors) - 1
        return None


class _TensorUnpickler(pickle.Unpickler):
    def __init__(self, file, tensors: Sequence[torch.Tensor]):
        super().__init__(file)
        self.tensors = tensors

    def persistent_load(self, pid):
        return self.tensors[pid]


def _dumps(args: tuple) -> Tuple[bytes, List[torch.Tensor]]:
    buf, tensors = io.BytesIO(), []
    _TensorPickler(buf, tensors).dump(args)
    return buf.getvalue(), tensors


def _loads(blob: bytes, tensors: Sequence[torch.Tensor]) -> tuple:
    return _TensorUnpickler(io.BytesIO(blob), tensors).load()


class ActiveMsg:
    """Handle returned by ``Communicator.make_active_msg`` (paper's am->send)."""

    def __init__(self, comm: "Communicator", am_id: int, large: bool):
        self._comm = comm
        self.am_id = am_id
        self.large = large

    def send(self, dest: int, *args) -> None:
        self._comm._send_am(self, dest, args)

    # paper examples use `am->send(...)`; both spellings provided
    __call__ = send


class _SeqSeen:
    """Receiver-side dedup state for one source: every seq <= ``cum`` has
    been delivered, plus the out-of-order set ``extra`` (compacted)."""

    __slots__ = ("cum", "extra")

    def __init__(self):
        self.cum = -1
        self.extra: Set[int] = set()

    def first_delivery(self, seq: int) -> bool:
        if seq <= self.cum or seq in self.extra:
            return False
        self.extra.add(seq)
        while self.cum + 1 in self.extra:
            self.cum += 1
            self.extra.discard(self.cum)
        return True


@dataclass
class _Pending:
    """One unacked reliable message at the sender."""

    wire: _Wire
    attempts: int = 0
    due: float = 0.0
    on_ack: Optional[Callable[[], None]] = None


class Communicator:
    """AM factory + transport endpoint for one rank (paper's Communicator).

    Maintains the three queues of §II-B2 (ready-to-send / in-flight sends /
    received-to-run); with the in-process transport the in-flight-send queue
    is the per-destination unacked window of the reliable layer, and a large
    AM's sender-completion callback fires when its ack arrives.
    """

    # retry schedule used when no FaultPlan overrides it
    _RETRY_BASE = 0.05
    _RETRY_BUDGET = 10
    _RETRY_CAP = 0.5

    def __init__(self, world: InProcWorld, rank: int):
        self.world = world
        self.rank = rank
        self.n_ranks = world.n_ranks
        self._registry: List[dict] = []
        self._send_lock = threading.Lock()
        # Monotone counters over *user* AMs only (q_r / p_r of §II-B3),
        # plus per-peer splits so counts attributable to a dead rank can be
        # excluded after a death declaration (epoch-fenced; see completion).
        self.queued_count = 0
        self.processed_count = 0
        self.queued_to = [0] * self.n_ranks
        self.processed_from = [0] * self.n_ranks
        self._adjust_q = 0
        self._adjust_p = 0
        self._counted_dead: Set[int] = set()
        # reliable layer state
        self._next_seq: Dict[int, Any] = {
            d: itertools.count() for d in range(self.n_ranks)}
        self._pending: Dict[int, Dict[int, _Pending]] = {
            d: {} for d in range(self.n_ranks)}
        self._seen: Dict[int, _SeqSeen] = {
            s: _SeqSeen() for s in range(self.n_ranks)}
        self.suspected: Set[int] = set()
        f = world.faults
        self._retry_base = f.retry_base if f else self._RETRY_BASE
        self._retry_budget = f.retry_budget if f else self._RETRY_BUDGET
        self._last_hb = 0.0
        self._tp = None
        self._detector = None  # attached by runtime for distributed join
        # recovery hook: called as on_reconfigure(newly_dead, assignment,
        # epoch) from the progress thread when a death is applied
        self.on_reconfigure: Optional[Callable] = None
        self.shutdown = threading.Event()

    # ----------------------------------------------------------- factories

    def make_active_msg(self, fn: Callable[..., None]) -> ActiveMsg:
        am_id = self.world.register_fingerprint(self.rank, f"am:{fn.__name__}")
        self._registry.append({"fn": fn, "large": False})
        return ActiveMsg(self, am_id, large=False)

    def make_large_active_msg(
        self,
        fn: Callable[..., None],
        alloc: Callable[..., Any],
        complete: Callable[[], None],
    ) -> ActiveMsg:
        """Large AM (§II-A2a): ``alloc(*args)`` returns the receiver buffer
        (a tensor, or a numpy array) the view is copied into on the
        buffer's device (zero extra copy); ``fn(*args)`` processes it after
        arrival; ``complete()`` runs on the *sender* once its buffer is
        reusable — i.e. when the transport ack arrives, since the buffer may
        be retransmitted until then."""
        am_id = self.world.register_fingerprint(self.rank, f"lam:{fn.__name__}")
        self._registry.append({"fn": fn, "large": True, "alloc": alloc,
                               "complete": complete})
        return ActiveMsg(self, am_id, large=True)

    # -------------------------------------------------------------- sending

    def _send_am(self, am: ActiveMsg, dest: int, args: Sequence[Any]) -> None:
        views = [a for a in args if isinstance(a, view)]
        plain = tuple(a for a in args if not isinstance(a, view))
        if am.large:
            if len(views) != 1:
                raise ValueError("a large AM payload must contain exactly one view")
            raw = views[0].array  # sent directly — no temporary copy
        else:
            if views:
                # Regular AMs copy everything — views included.
                plain = tuple(a.array if isinstance(a, view) else a
                              for a in args)
            raw = None
        # the paper's temporary serialization buffer: the pickle of the
        # plain args, and an on-device copy of each tensor arg
        blob, tensors = _dumps(plain)
        device_ok = self.world.carries_device_tensors
        if not device_ok:
            for t in tensors + ([raw] if raw is not None else []):
                if not on_host(t):
                    raise ValueError(
                        f"an active message carries a tensor on {t.device}, "
                        "but this transport pickles its frames across "
                        "processes and takes host data only (numpy arrays "
                        "or CPU tensors); use the inproc transport to keep "
                        "payloads on the device")
        tensors = tuple(t.clone() for t in tensors)
        if self.world.check_dead_or_kill(self.rank):
            raise RankKilled(f"rank {self.rank} killed by fault plan")
        with self._send_lock:
            if dest in self.world.dead:
                return  # fenced: never counted, never delivered
            self.queued_count += 1
            self.queued_to[dest] += 1
            payload_stats.note(self.rank, dest, tensors + (
                (raw,) if raw is not None else ()), pickled=not device_ok)
            wire = _Wire("large_am" if am.large else "am",
                         self.rank, am.am_id, blob, raw, tensors=tensors)
            on_ack = self._registry[am.am_id]["complete"] if am.large else None
            self._post_reliable(dest, wire, on_ack)

    def protocol_send(self, dest: int, kind: str, meta: Any) -> None:
        """Completion-protocol traffic — excluded from q/p counts, but
        riding the reliable layer (COUNT/REQUEST/... must survive loss)."""
        with self._send_lock:
            if self.rank in self.world.dead or dest in self.world.dead:
                return
            self._post_reliable(dest, _Wire(kind, self.rank, meta=meta), None)

    def _post_reliable(self, dest: int, wire: _Wire,
                       on_ack: Optional[Callable]) -> None:
        """Assign a seq, record the unacked entry, first transmission.
        Caller holds ``_send_lock``."""
        wire.seq = next(self._next_seq[dest])
        self._pending[dest][wire.seq] = _Pending(
            wire, attempts=0, due=time.monotonic() + self._retry_base,
            on_ack=on_ack)
        self.world.send(dest, wire)

    def _post_raw(self, dest: int, kind: str, meta: Any) -> None:
        """Unsequenced transport traffic (acks, heartbeats)."""
        self.world.send(dest, _Wire(kind, self.rank, meta=meta))

    # ------------------------------------------------------------- recovery

    def drop_rank_counts(self, newly_dead: Sequence[int]) -> None:
        """A death was declared: stop attributing traffic to the dead ranks.
        Counter splits are frozen (the world fence stops post-death sends
        before they are counted), so the one-shot adjustment here keeps the
        *effective* counts consistent over the survivor set. Unacked sends
        to the dead are abandoned (their large-AM buffers are reusable —
        nothing will retransmit them)."""
        callbacks: List[Callable] = []
        with self._send_lock:
            for d in newly_dead:
                if d in self._counted_dead:
                    continue
                self._counted_dead.add(d)
                self._adjust_q += self.queued_to[d]
                self._adjust_p += self.processed_from[d]
                abandoned = self._pending.get(d, {})
                self._pending[d] = {}
                self.suspected.discard(d)
                callbacks.extend(p.on_ack for p in abandoned.values()
                                 if p.on_ack)
        for cb in callbacks:
            cb()

    def effective_counts(self):
        """(q, p) over the *current survivor set* — raw monotone counters
        minus everything queued-to / processed-from declared-dead ranks."""
        with self._send_lock:
            return (self.queued_count - self._adjust_q,
                    self.processed_count - self._adjust_p)

    # ------------------------------------------------------------- progress

    def attach_threadpool(self, tp) -> None:
        self._tp = tp

    def attach_detector(self, detector) -> None:
        self._detector = detector

    def _maybe_heartbeat(self) -> None:
        f = self.world.faults
        if f is None or self._detector is None or self.rank == 0:
            return
        now = time.monotonic()
        if now - self._last_hb >= f.heartbeat_every:
            self._last_hb = now
            self._post_raw(0, HEARTBEAT, None)

    def _retransmit_due(self) -> None:
        now = time.monotonic()
        resend: List[_Wire] = []
        dests: List[int] = []
        with self._send_lock:
            for dst, pend in self._pending.items():
                if not pend or dst in self.world.dead:
                    continue
                for p in pend.values():
                    if p.due > now:
                        continue
                    p.attempts += 1
                    if p.attempts >= self._retry_budget and \
                            dst not in self.suspected:
                        # budget exhausted: report, keep retrying at the cap
                        # (only the failure detector declares death)
                        self.suspected.add(dst)
                        self.world.report.note_suspect(dst)
                    p.due = now + min(self._retry_base * (2 ** p.attempts),
                                      self._RETRY_CAP)
                    resend.append(p.wire)
                    dests.append(dst)
        for dst, wire in zip(dests, resend):
            self.world.report.bump("retries")
            self.world.send(dst, wire)

    def _on_ack(self, src: int, seq: int) -> None:
        with self._send_lock:
            p = self._pending.get(src, {}).pop(seq, None)
            self.suspected.discard(src)
        if p is not None and p.on_ack is not None:
            p.on_ack()  # large-AM sender buffer is reusable now

    def progress(self, *, transport_only: bool = False) -> None:
        """One progress step of the main/MPI thread (§II-B2)."""
        self._maybe_heartbeat()
        self._retransmit_due()
        for wire in self.world.poll(self.rank):
            if self._detector is not None:
                # any traffic from a rank is proof of life, not just HBs
                self._detector.on_heartbeat(wire.src)
            if wire.kind == ACK:
                self._on_ack(wire.src, wire.meta)
                continue
            if wire.kind == HEARTBEAT:
                if self._detector is not None:
                    self._detector.on_heartbeat(wire.src)
                continue
            if wire.seq >= 0:
                # reliable delivery: always ack (acks are idempotent), then
                # drop anything already delivered — retransmits and injected
                # duplicates alike never reach the counters twice
                self._post_raw(wire.src, ACK, wire.seq)
                if not self._seen[wire.src].first_delivery(wire.seq):
                    self.world.report.bump("dup_suppressed")
                    continue
            if wire.kind == "am":
                if transport_only:
                    raise RuntimeError(
                        "user AM arrived after local shutdown linger began")
                entry = self._registry[wire.am_id]
                entry["fn"](*_loads(wire.blob, wire.tensors))
                self.processed_count += 1
                self.processed_from[wire.src] += 1
            elif wire.kind == "large_am":
                if transport_only:
                    raise RuntimeError(
                        "user AM arrived after local shutdown linger began")
                entry = self._registry[wire.am_id]
                args = _loads(wire.blob, wire.tensors)
                buf = torch.as_tensor(entry["alloc"](*args))
                buf.copy_(wire.raw.reshape(buf.shape))
                entry["fn"](*args)
                self.processed_count += 1
                self.processed_from[wire.src] += 1
            else:
                self._detector.on_message(wire)

    def poll_failure_detector(self) -> None:
        """Drive the attached detector's failure half only (lease checks and
        DEATH declaration) — the resident scheduler's between-submissions
        heartbeat of the membership protocol, with the quiescence rounds
        deliberately left to the final ``tp.join()``."""
        if self._detector is not None:
            self._detector.poll_failures()

    def worker_idle(self) -> bool:
        return self._tp is None or self._tp.quiescent()

    def run_until_shutdown(self) -> None:
        """Main-thread loop: progress + completion detection until SHUTDOWN,
        then an ack linger so no peer is left retransmitting into the void."""
        if self._detector is None:
            # Single-rank shared-memory mode: local quiescence == completion.
            while not (self.worker_idle() and not self._has_traffic()):
                self.progress()
                time.sleep(20e-6)
            self.shutdown.set()
            return
        while not self.shutdown.is_set():
            if self.world.poison.is_set():
                raise WorldPoisoned("world poisoned: another rank failed")
            if self.rank in self.world.dead:
                raise RankKilled(f"rank {self.rank} killed by fault plan")
            self.progress()
            self._detector.step()
            time.sleep(10e-6)
        self._drain_shutdown()

    def _drain_shutdown(self) -> None:
        """Post-SHUTDOWN linger: quiescence is proven, but transport-level
        traffic (acks for our last sends, retransmits from peers whose acks
        were lost) may still be in flight. Keep acking/retransmitting until
        every rank has flagged that its unacked window is empty; a rank that
        stopped cold here would leave peers retrying into the void until
        their budgets exhausted."""
        flagged = False
        while True:
            if self.world.poison.is_set():
                return
            self.progress(transport_only=True)
            if not flagged and not self._has_unacked():
                self.world.flag_shutdown(self.rank)
                flagged = True
            if flagged and self.world.all_shutdown():
                return
            time.sleep(20e-6)

    def _has_unacked(self) -> bool:
        with self._send_lock:
            return any(pend and dst not in self.world.dead
                       for dst, pend in self._pending.items())

    def _has_traffic(self) -> bool:
        return self.world.has_traffic(self.rank)

    # ---------------------------------------------------------- diagnostics

    def snapshot(self) -> dict:
        """Last-known protocol state, for timeout forensics."""
        with self._send_lock:
            unacked = {d: len(p) for d, p in self._pending.items() if p}
        q, p = self.effective_counts()
        snap = {
            "rank": self.rank,
            "queued": self.queued_count,
            "processed": self.processed_count,
            "effective_q": q,
            "effective_p": p,
            "unacked": unacked,
            "suspected": sorted(self.suspected),
            "worker_quiescent": self.worker_idle(),
            "shutdown": self.shutdown.is_set(),
        }
        if self._detector is not None:
            snap["detector"] = self._detector.snapshot()
        return snap
