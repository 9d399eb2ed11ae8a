"""The persistent, multi-tenant scheduler service (the port's copy of the
JAX package's ``repro.sched.service``).

One-shot execution (``Graph.run_host``) spins up ranks, runs one graph,
and tears the world down. The service keeps the ranks *resident*: a
stream of PTGs from many concurrent clients is assimilated into one live
dependency state and tasks run as predecessors complete — TaskTorrent's
"the DAG is discovered piece by piece, as messages arrive" lifted from
one graph to an open-ended stream of them.

Architecture (all in-process, mirroring the paper's rank model):

- the **frontdoor** (:class:`SchedulerService` + :class:`Client`) accepts
  submissions, applies admission control (max in-flight tasks per client
  — ``submit`` blocks, which is the backpressure), assigns monotone
  submission ids, and appends SUBMIT / FAIL / WATERMARK / STOP commands
  to a **submission bus** — an append-only log every rank consumes at its
  own cursor. The bus's total order is the determinism anchor: all ranks
  resolve identical cross-submission bindings because they all see the
  same prefix in the same order;
- each rank runs a :class:`ShardRuntime`: a resident loop that pumps the
  communicator, assimilates new submissions **via the lazy path only**
  (``Graph.derive_local`` — owned tasks + halo; no rank ever materializes
  a global edge dict), and lets the work-stealing threadpool execute
  ready tasks. The loop never drives the completion detector's quiescence
  rounds (which would tear the world down at the first idle moment), only
  its failure-detection half;
- per-submission wiring reuses the host-runtime shape (indegree from the
  view's in-edges plus its external reads, cross-rank fulfillments as
  active messages carrying the block iff the consumer reads it), but all
  ranks share **one dispatcher-AM set registered at rank start** —
  registration order is the global AM identity, so submissions arriving
  later must not register new ones;
- cross-submission data flows through named block namespaces
  (:mod:`repro_torch.sched.namespace`); retirement
  (:mod:`repro_torch.sched.state`) keeps memory on the live frontier; the
  ready queue is ordered by the weighted-fair policy
  (:mod:`repro_torch.sched.fair`).

Failure is per-submission, not per-service: a task body that raises fails
its submission's future and poisons the namespace versions it will never
produce (readers fail loudly instead of hanging) — other clients and
unrelated submissions are untouched.

**Rank death** (active when the world carries a
:class:`~repro_torch.core.faults.FaultPlan`) is survived, not fatal: the
serve loop drives the membership half of the completion protocol
(``poll_failure_detector``), so a resident rank that dies mid-stream is
declared dead by rank 0's lease monitor and a DEATH broadcast reaches the
survivors. Each survivor's ``on_reconfigure`` hook then

- **adopts** the dead rank's shards (deterministic next-live-rank
  assignment, same as the one-shot runtime): the adopter reseeds its
  namespace shard from the frontdoor's *resolved-prefix checkpoint*
  (honored seeds + published versions + poisons of resolved submissions,
  retired in lockstep with the watermark) and **replays the submission
  bus** from the dead rank's frozen cursor — re-deriving each unresolved
  submission's LocalView for the adopted shard and re-executing only the
  lost tasks. Replay is idempotent: already-published versions are final
  (``publish``/``restore`` never downgrade), already-retired blocks are
  discarded by the ``_retired`` guard, and re-produced cross-shard
  fulfillments are deduped per (consumer, producer) at the receiver;
- **replays its send log** (cross-rank fulfillments and publishes whose
  destination shard moved) and re-issues outstanding fetches along the new
  route, so in-flight state lost with the dead rank is reconstructed;
- keeps the frontdoor futures alive: the dead rank's shards are re-added
  to every unresolved record's pending set and the adopter re-reports, so
  clients observe an epoch change only as latency.

The bus-trim invariant that makes replay sound: a dead rank's cursor is
**frozen** at the DEATH declaration and keeps pinning the trim until every
adopter of its shards has finished replaying (``retire_reader`` votes), and
the **floor** — the oldest unresolved submission's SUBMIT position — pins
the trim unconditionally, so replay never reads a trimmed prefix
(``read_range`` asserts it loudly).

**Blocks on a device.** The service has one device (``cuda`` unless the
caller passes ``device="cpu"``), and every block it holds is a tensor
there: a submission's initial values are copied there once per
assimilation (its own copy, never an alias of the caller's), namespace
versions, halo copies and AM payloads stay there (under ``inproc`` an AM
carries an on-device ``clone()``, see :mod:`repro_torch.core.messages`),
and ``result()`` returns tensors there. A body whose result lies on
another device fails its own submission. Every body runs on the device's
default stream, whichever worker launches it: a consumer is launched only
after its producer's body returned, so stream order carries every
dependence, and a retired block's memory is reused by the caching
allocator only behind the launches that read it. ``multiproc`` forks its
ranks and takes ``device="cpu"`` only (numpy bodies there).

Client-facing robustness layers on top: per-submission **deadlines**
(over-deadline submissions are shed through the same FAIL/poisoning path —
a clean :class:`DeadlineExceeded`, never a hang), bounded **retry** with
exponential backoff (``Client.submit(..., retries=)``), and **graceful
degradation** — admission backpressure tightens to the surviving ranks'
capacity when the service shrinks (the elastic controller from
:mod:`repro_torch.train.elastic` tracks membership and can admit a
replacement rank into the live stream).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional

from repro_torch.core import runtime as core_runtime
from repro_torch.core.faults import FaultPlan
from repro_torch.core.messages import RankKilled, WorldPoisoned
from repro_torch.linalg.host_exec import as_block, ranks_device, to_store

from .fair import FairPolicy
from .namespace import AVAILABLE, POISONED, NamespaceShard
from .state import LiveStats, SubmissionShard

K = Hashable
B = Hashable


class SubmissionError(RuntimeError):
    """A submission failed (its own body raised, or an upstream submission
    it reads from failed before producing the block)."""


class DeadlineExceeded(SubmissionError):
    """A submission's deadline passed before it resolved: the service shed
    it (FAIL + namespace poisoning, so downstream readers fail loudly) and
    its future raises this instead of hanging on a degraded service."""


# ---------------------------------------------------------------- frontdoor


@dataclass
class Submission:
    sub_id: int
    client: str
    namespace: str
    graph: object
    blocks: dict
    bodies: dict
    owner_map: Optional[Callable]
    priority: float
    n_tasks: int
    # ephemeral: no later submission will ever target this namespace, so
    # its state is dropped wholesale once the watermark passes (Client.map)
    ephemeral: bool = False

    def owner(self) -> Callable[[B], int]:
        return self.owner_map if self.owner_map is not None \
            else self.graph.owner


class SubmissionFuture:
    """Handle for one submission: ``result()`` returns the blocks the
    submission wrote (block id -> value), the same contract as the
    one-shot ``run_host`` — which is what makes bit-identity checkable.

    A ``result`` timeout raises with the service's forensic snapshot
    (per-rank protocol state, bus cursors, unresolved submissions) instead
    of a bare TimeoutError — the stuck side is named, not guessed."""

    def __init__(self, sub_id: int, client: str, n_tasks: int, svc=None):
        self.sub_id = sub_id
        self.client = client
        self.n_tasks = n_tasks
        self._svc = svc
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self._transform: Optional[Callable] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            detail = ""
            if self._svc is not None:
                try:  # forensics must never mask the timeout itself
                    detail = "\n" + self._svc.debug_snapshot()
                except Exception as e:
                    detail = f"\n<debug snapshot failed: {e!r}>"
            raise TimeoutError(
                f"submission {self.sub_id} not done after {timeout}s{detail}")
        if self._exc is not None:
            raise self._exc
        return (self._transform(self._result) if self._transform
                else self._result)

    def _complete(self, blocks) -> None:
        self._result = blocks
        self._ev.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()


class RetryingFuture:
    """Future facade from ``Client.submit(..., retries=N)``: on a shed
    (:class:`DeadlineExceeded`), resubmits after an exponential backoff,
    up to ``retries`` times. Only the deadline-shed path retries — a
    submission whose own body raised would deterministically raise again.

    Retries re-run the whole submission, so they are sound for
    self-contained work (ephemeral namespaces get a fresh one per attempt;
    a retry into a durable namespace re-seeds only all-POISONED timelines
    — its reads of healthy earlier writes bind unchanged, but a poisoned
    *upstream* stays poisoned and the retry budget just burns down)."""

    def __init__(self, attempt: Callable[[int], SubmissionFuture],
                 first: SubmissionFuture, retries: int, backoff: float):
        self._attempt = attempt
        self._fut = first
        self._retries = retries
        self._backoff = backoff
        self.attempts = 1

    @property
    def sub_id(self) -> int:
        return self._fut.sub_id

    @property
    def client(self) -> str:
        return self._fut.client

    @property
    def _transform(self):
        return self._fut._transform

    @_transform.setter
    def _transform(self, fn) -> None:
        self._fut._transform = fn

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        n = 0
        while True:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            try:
                return self._fut.result(left)
            except DeadlineExceeded:
                if n >= self._retries:
                    raise
                time.sleep(min(self._backoff * (2.0 ** n), 5.0))
                n += 1
                fresh = self._attempt(n)
                fresh._transform = self._fut._transform
                self._fut = fresh
                self.attempts += 1


class _Bus:
    """Append-only command log; ranks read at their own cursor. The total
    order of appends IS the stream's sequential semantics. Cursors are
    absolute (they keep counting up forever), but storage is not: the
    prefix every reader has consumed can never be read again and is
    trimmed away, so a resident service holds O(unconsumed commands), not
    the whole stream history.

    Two pins keep adoption replay sound against that trim:

    - a **frozen** reader (a rank declared dead) stops reading — its
      recorded cursor (always <= the commands it actually applied, since
      the cursor is recorded at batch start) keeps pinning the trim until
      every adopter of its shards has replayed past it and voted
      ``retire_reader``;
    - the **floor** — the oldest unresolved submission's SUBMIT position,
      maintained by the frontdoor — pins the trim unconditionally, so an
      unresolved submission the dead rank had already consumed can still
      be re-read for re-derivation.
    """

    def __init__(self, n_readers: int) -> None:
        self._items: List[tuple] = []
        self._base = 0                      # absolute index of _items[0]
        self._cursors = [0] * n_readers
        self._frozen: set = set()           # dead readers, pre-adoption
        self._retired_readers: set = set()  # dead readers fully replayed
        self._retire_votes: Dict[int, int] = {}
        self._floor: Optional[int] = None
        self._lock = threading.Lock()
        self.posted = 0

    def post(self, item: tuple, pin: bool = False) -> int:
        """Append; returns the absolute position. ``pin=True`` (SUBMITs)
        atomically lowers the floor to this position if none is set, so
        there is no window where a fast reader's trim could eat a SUBMIT
        before the frontdoor records it as unresolved."""
        with self._lock:
            pos = self._base + len(self._items)
            self._items.append(item)
            self.posted += 1
            if pin and self._floor is None:
                self._floor = pos
            return pos

    def set_floor(self, pos: Optional[int]) -> None:
        with self._lock:
            self._floor = pos

    def floor(self) -> Optional[int]:
        with self._lock:
            return self._floor

    def read_from(self, cursor: int, reader: int) -> List[tuple]:
        with self._lock:
            if reader in self._frozen or reader in self._retired_readers:
                # a killed rank's serve thread may spin briefly before it
                # notices the fence: its cursor stays frozen for replay
                return []
            self._cursors[reader] = cursor
            self._trim()
            return self._items[cursor - self._base:]

    def read_range(self, lo: int, hi: int) -> List[tuple]:
        """Adoption replay: absolute ``[lo, hi)``. The freeze/floor
        invariants make a trimmed ``lo`` impossible — raising here means
        the invariant broke, and a loud error beats a silent partial
        replay."""
        with self._lock:
            if lo < self._base:
                raise RuntimeError(
                    f"bus replay would read below the trimmed prefix: "
                    f"lo={lo} < base={self._base} (a dead rank's frozen "
                    "cursor was outrun by the trim)")
            return self._items[max(0, lo - self._base):
                               max(0, hi - self._base)]

    def freeze(self, reader: int) -> None:
        with self._lock:
            self._frozen.add(reader)

    def frozen_cursor(self, reader: int) -> int:
        with self._lock:
            return self._cursors[reader]

    def retire_reader(self, reader: int, votes_needed: int = 1) -> None:
        """One adopter finished replaying ``reader``'s prefix. The cursor
        pin lifts only at the last vote — a dead rank's shards can land on
        several adopters, and the first finisher must not unpin the prefix
        the others still need."""
        with self._lock:
            if reader in self._retired_readers:
                return
            self._retire_votes[reader] = self._retire_votes.get(reader, 0) + 1
            if self._retire_votes[reader] >= votes_needed:
                self._frozen.discard(reader)
                self._retired_readers.add(reader)
                self._trim()

    def _trim(self) -> None:
        # caller holds the lock
        lows = [c for r, c in enumerate(self._cursors)
                if r not in self._retired_readers]
        if self._floor is not None:
            lows.append(self._floor)
        low = min(lows) if lows else self._base + len(self._items)
        if low > self._base:
            del self._items[:low - self._base]
            self._base = low

    def snapshot(self) -> dict:
        with self._lock:
            return {"base": self._base, "posted": self.posted,
                    "backlog": len(self._items), "floor": self._floor,
                    "cursors": list(self._cursors),
                    "frozen": sorted(self._frozen),
                    "retired_readers": sorted(self._retired_readers)}


@dataclass
class _SubRecord:
    sub: Submission
    future: SubmissionFuture
    pending_ranks: set                    # shard ids still to report
    published: dict = field(default_factory=dict)
    t0: float = 0.0
    resolved: bool = False
    failed: bool = False
    bus_pos: int = 0
    deadline: Optional[float] = None      # absolute monotonic shed time
    seeded: dict = field(default_factory=dict)   # honored seeds (rank truth)
    bytes_by_shard: dict = field(default_factory=dict)


class Client:
    """Per-tenant frontdoor handle: submissions, accounting, admission.

    ``max_inflight_tasks`` is the admission-control knob: ``submit``
    blocks while the client's in-flight task count would exceed it (a
    single oversized submission is admitted alone rather than deadlocking).
    When ranks have died, the effective cap shrinks proportionally to the
    surviving capacity — graceful degradation instead of a queue growing
    at full-speed admission into a half-speed service. ``weight`` feeds
    the ranks' fair policy. ``stats`` accumulates tasks, bytes (result
    blocks produced), and wall seconds per submission.
    """

    def __init__(self, service: "SchedulerService", name: str, *,
                 weight: float = 1.0,
                 max_inflight_tasks: Optional[int] = None,
                 namespace: Optional[str] = None):
        self._svc = service
        self.name = name
        self.weight = weight
        self.max_inflight_tasks = max_inflight_tasks
        self.namespace = namespace if namespace is not None else name
        self._map_seq = itertools.count()
        self.inflight_tasks = 0
        self.stats = {"submitted": 0, "completed": 0, "failed": 0,
                      "tasks": 0, "bytes": 0, "wall_seconds": 0.0}

    def submit(self, graph, blocks=None, bodies=None, *,
               owner_map: Optional[Callable] = None,
               priority: float = 0.0,
               namespace: Optional[str] = None,
               ephemeral: bool = False,
               timeout: Optional[float] = None,
               deadline: Optional[float] = None,
               retries: int = 0,
               retry_backoff: float = 0.25):
        """Submit one PTG against a namespace; returns a future for its
        written blocks. External reads (blocks no task of this graph
        writes first) bind to the namespace — earlier submissions' final
        writes win over ``blocks``' initial values. Blocks of the graph
        must keep one owner across the namespace's submissions.
        ``ephemeral=True`` declares that no later submission will target
        the namespace: its block state is dropped wholesale once this
        submission resolves, instead of its last versions living on as
        the namespace's durable values.

        ``timeout`` bounds the admission wait (backpressure). ``deadline``
        bounds the submission's *life*: seconds from admission after which
        the service sheds it and the future raises
        :class:`DeadlineExceeded`. ``retries`` > 0 wraps the future so a
        shed attempt is resubmitted after an exponential backoff
        (``retry_backoff`` seconds, doubling, capped at 5s); ephemeral
        namespaces get a fresh ``~rN`` namespace per attempt."""
        n_tasks = sum(1 for _ in graph._program_iter())
        ns0 = namespace if namespace is not None else self.namespace

        def attempt(n: int) -> SubmissionFuture:
            ns = ns0 if (n == 0 or not ephemeral) else f"{ns0}~r{n}"
            return self._svc._admit(
                self, graph, dict(blocks or {}), dict(bodies or {}),
                owner_map=owner_map, priority=priority, namespace=ns,
                ephemeral=ephemeral, n_tasks=n_tasks, timeout=timeout,
                deadline=deadline)

        fut = attempt(0)
        if retries <= 0:
            return fut
        return RetryingFuture(attempt, fut, retries, retry_backoff)

    def map(self, fn: Callable, values, *, priority: float = 0.0,
            deadline: Optional[float] = None, retries: int = 0):
        """Embarrassingly parallel convenience: one task per element of
        ``values``, sharded round-robin; ``result()`` returns the mapped
        list in order. Each call runs in its own private throwaway
        namespace (unique per call — reusing one would bind this call's
        ``("x", i)`` reads to a previous call's seeds, since a namespace
        honors initial values only on virgin timelines) that is dropped
        wholesale once the call resolves."""
        from repro_torch.ptg import Graph, IndexSpace

        vals = list(values)
        n = self._svc.n_shards
        g = Graph(f"map-{self.name}", n_shards=n,
                  owner=lambda blk: blk[1] % n)
        g.task_type("map",
                    writes=lambda i: ("y", i),
                    reads=lambda i: [("x", i)],
                    space=IndexSpace(
                        lambda: range(len(vals)),
                        lambda s: [i for i in range(len(vals))
                                   if i % n == s],
                        size=len(vals)))
        dev = self._svc.device
        blocks = {("x", i): to_store(v, dev) for i, v in enumerate(vals)}
        fut = self.submit(g, blocks, {"map": fn}, priority=priority,
                          namespace=f"{self.name}/map{next(self._map_seq)}",
                          ephemeral=True, deadline=deadline, retries=retries)
        fut._transform = lambda out: [out[("y", i)]
                                      for i in range(len(vals))]
        return fut


# ------------------------------------------------------------------ service


class SchedulerService:
    """The resident scheduler. Typical use::

        with SchedulerService(n_shards=2) as svc:
            alice = svc.client("alice", weight=2.0)
            fut = alice.submit(graph, blocks, bodies)
            out = fut.result()

    ``start()`` launches a driver thread running ``run_ranks(...,
    serve_scheduler=self)``; ranks stay resident between submissions.
    ``close()`` (or leaving the ``with``) waits for in-flight work, posts
    STOP, and runs the distributed completion protocol to tear down.
    ``faults`` (a :class:`~repro_torch.core.faults.FaultPlan`) makes the
    world adversarial — and arms the recovery machinery described in the
    module docstring. ``device`` holds every block (``cuda`` by default;
    raises when no GPU is present, with no fallback to the CPU);
    ``transport="multiproc"`` takes ``device="cpu"`` only.
    """

    def __init__(self, n_shards: int, *, n_threads: int = 2,
                 timeout: float = 120.0,
                 faults: Optional[FaultPlan] = None,
                 transport: Optional[str] = None,
                 device="cuda"):
        self.device = ranks_device(device, transport)
        self.n_shards = n_shards
        self.n_threads = n_threads
        self.timeout = timeout
        self.faults = faults
        self.transport = transport
        self.bus = _Bus(n_shards)
        self.draining = threading.Event()  # run_ranks arms its deadline here
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._clients: Dict[str, Client] = {}
        self._subs: Dict[int, _SubRecord] = {}
        self._next_sub = 1
        self._resolved_through = 0
        self._accepting = False
        self._closed = False
        self._driver: Optional[threading.Thread] = None
        self._driver_err: Optional[BaseException] = None
        self._reaper: Optional[threading.Thread] = None
        self.rank_stats: List[Optional[LiveStats]] = [None] * n_shards
        self.rank_summaries: Optional[list] = None
        self.recovery_report = None
        # --- recovery state (armed by attach_world iff faults are active)
        self._world = None
        self._recoverable = faults is not None
        self._runtimes: List[Optional["ShardRuntime"]] = [None] * n_shards
        # resolved-prefix checkpoint: the adopter's namespace seed corpus.
        # Private LiveStats — checkpoint bookkeeping must not pollute the
        # ranks' live_frac measurement.
        self._ns_ckpt = NamespaceShard(LiveStats())
        self._ns_owner: Dict[str, Callable] = {}
        self._dead_ranks: set = set()
        self._dead_shards: set = set()
        self._death_t0: Optional[float] = None
        self._inflight_at_death: Optional[set] = None
        self.sched_recover_ms: Optional[float] = None
        self._elastic = None
        self.elastic_plan = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "SchedulerService":
        if self._driver is not None:
            raise RuntimeError("scheduler already started")
        self._accepting = True
        self._driver = threading.Thread(target=self._drive, daemon=True,
                                        name="sched-driver")
        self._driver.start()
        self._reaper = threading.Thread(target=self._reap, daemon=True,
                                        name="sched-reaper")
        self._reaper.start()
        return self

    def __enter__(self) -> "SchedulerService":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(wait=exc_type is None)

    def attach_world(self, world) -> None:
        """Called by ``run_ranks`` in resident mode. The recovery machinery
        (cursor freezing, checkpointing, adoption re-reports, elastic
        membership) arms only when the world injects faults — the
        fault-free service pays nothing for survivability it cannot
        need. This also catches faults injected *around* us (the chaos
        wrapper hands ``run_ranks`` a plan the service never saw)."""
        self._world = world
        if world.faults is not None and not self._recoverable:
            self._recoverable = True
        if self._recoverable and self._elastic is None:
            from repro_torch.train.elastic import ElasticController
            lease = world.faults.lease if world.faults is not None else 60.0
            self._elastic = ElasticController(
                self.n_shards, chips_per_host=1, model_axis=1,
                dead_after=lease)

    def _drive(self) -> None:
        try:
            # attribute lookup at call time so the chaos-injection wrapper
            # (conftest REPRO_CHAOS) sees this run_ranks call too
            kwargs = {"faults": self.faults} if self.faults is not None else {}
            if self.transport is not None:
                kwargs["transport"] = self.transport
            res = core_runtime.run_ranks(
                self.n_shards, self._rank_main, n_threads=self.n_threads,
                timeout=self.timeout, serve_scheduler=self, **kwargs)
            if isinstance(res, tuple):
                self.rank_summaries, self.recovery_report = res
            else:
                self.rank_summaries = res
        except BaseException as e:
            self._driver_err = e
            with self._cond:
                for rec in self._subs.values():
                    if not rec.resolved:
                        rec.resolved = rec.failed = True
                        rec.future._fail(SubmissionError(
                            f"scheduler service died: {e!r}"))
                self._accepting = False
                self._cond.notify_all()

    def _reap(self) -> None:
        """Deadline enforcement: shed over-deadline submissions through the
        normal FAIL path — a degraded (or dying) service fails them
        cleanly instead of letting clients hang."""
        while not self.draining.wait(timeout=0.05):
            now = time.monotonic()
            with self._cond:
                over = [s for s, r in self._subs.items()
                        if not r.resolved and r.deadline is not None
                        and now >= r.deadline]
            for s in over:
                self._fail_submission(s, DeadlineExceeded(
                    f"submission {s} shed: deadline passed before "
                    "completion"))

    def close(self, *, wait: bool = True) -> None:
        """Stop accepting, optionally drain in-flight submissions, then
        shut the ranks down through the completion protocol."""
        if self._closed:
            return
        deadline = time.monotonic() + self.timeout
        with self._cond:
            self._accepting = False
            if wait:
                while (any(not r.resolved for r in self._subs.values())
                       and self._driver_err is None):
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._cond.wait(timeout=min(left, 0.5)):
                        if time.monotonic() >= deadline:
                            break
        self.draining.set()
        self.bus.post(("stop",))
        self._closed = True
        if self._reaper is not None:
            self._reaper.join(timeout=2.0)
        if self._driver is not None:
            self._driver.join(self.timeout)
        if self._driver_err is not None:
            raise RuntimeError("scheduler service failed") \
                from self._driver_err

    # ------------------------------------------------------------- clients

    def client(self, name: str, **kwargs) -> Client:
        with self._lock:
            if name in self._clients:
                raise ValueError(f"client {name!r} already registered")
            c = Client(self, name, **kwargs)
            self._clients[name] = c
            return c

    def client_weight(self, name: str) -> float:
        c = self._clients.get(name)
        return c.weight if c is not None else 1.0

    # ----------------------------------------------------------- admission

    def _effective_cap(self, cap: Optional[int]) -> Optional[int]:
        # caller holds the lock. Shrink admission to surviving capacity:
        # n-1 of n ranks => the client's window shrinks by the same ratio
        # (floor 1 task so progress is always possible).
        if cap is None or not self._dead_ranks:
            return cap
        live = self.n_shards - len(self._dead_ranks)
        return max(1, int(cap * live / self.n_shards))

    def _admit(self, client: Client, graph, blocks, bodies, *,
               owner_map, priority, namespace, ephemeral, n_tasks,
               timeout, deadline=None) -> SubmissionFuture:
        adm_deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                cap = self._effective_cap(client.max_inflight_tasks)
                if not (cap is not None and client.inflight_tasks > 0
                        and client.inflight_tasks + n_tasks > cap):
                    break
                if self._driver_err is not None or self._closed:
                    break
                left = None if adm_deadline is None \
                    else adm_deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"client {client.name!r}: admission blocked "
                        f"({client.inflight_tasks} tasks in flight, "
                        f"effective cap {cap})")
                self._cond.wait(timeout=0.5 if left is None
                                else min(left, 0.5))
            if not self._accepting:
                raise RuntimeError("scheduler service is not accepting "
                                   "submissions (closed or not started)")
            sub_id = self._next_sub
            self._next_sub += 1
            sub = Submission(sub_id, client.name, namespace, graph, blocks,
                             bodies, owner_map, priority, n_tasks,
                             ephemeral=ephemeral)
            fut = SubmissionFuture(sub_id, client.name, n_tasks, svc=self)
            rec = _SubRecord(sub, fut, set(range(self.n_shards)),
                             t0=time.monotonic())
            if deadline is not None:
                rec.deadline = rec.t0 + deadline
            self._subs[sub_id] = rec
            self._ns_owner[namespace] = sub.owner()
            client.inflight_tasks += n_tasks
            client.stats["submitted"] += 1
            # post inside the lock: bus order == sub_id order, always.
            # pin=True lowers the trim floor to this SUBMIT atomically —
            # an unresolved submission's SUBMIT is always re-readable.
            rec.bus_pos = self.bus.post(("submit", sub), pin=True)
        return fut

    # -------------------------------------------------- rank-side callbacks

    def _rank_done(self, sub_id: int, shard: int, published: dict,
                   n_bytes: int, seeded: Optional[dict] = None, *,
                   rank: int) -> None:
        with self._cond:
            rec = self._subs.get(sub_id)
            if rec is None or rec.resolved:
                return
            if rank in self._dead_ranks:
                # a killed rank's worker threads run on until they meet the
                # fence, and may finish a shard the death declaration has
                # already handed to an adopter: only the adopter's report
                # counts (the JAX package accepts it, resolving the
                # submission while the adopter still replays it)
                return
            if shard not in rec.pending_ranks:
                return   # duplicate report: account each shard exactly once
            rec.pending_ranks.discard(shard)
            rec.published.update(published)
            if seeded:
                rec.seeded.update(seeded)
            client = self._clients[rec.sub.client]
            # bytes accumulate per shard, replacing a previous report for
            # the same shard — an adopter re-reporting an adopted shard
            # must not double-count
            client.stats["bytes"] += n_bytes - rec.bytes_by_shard.get(shard, 0)
            rec.bytes_by_shard[shard] = n_bytes
            if rec.pending_ranks:
                return
            rec.resolved = True
            client.inflight_tasks -= rec.sub.n_tasks
            client.stats["completed"] += 1
            client.stats["tasks"] += rec.sub.n_tasks
            client.stats["wall_seconds"] += time.monotonic() - rec.t0
            if self._recoverable:
                self._checkpoint_resolved(rec)
            rec.future._complete(rec.published)
            # the future owns the result now; every shard has assimilated
            # (it reported done), so the record's payloads are dead weight
            rec.published = {}
            rec.sub.blocks = {}
            self._update_floor()
            self._note_drained(sub_id)
            self._advance_watermark()
            self._cond.notify_all()

    def _fail_submission(self, sub_id: int, exc: BaseException) -> None:
        with self._cond:
            rec = self._subs.get(sub_id)
            if rec is None or rec.resolved:
                return
            rec.resolved = rec.failed = True
            client = self._clients[rec.sub.client]
            client.inflight_tasks -= rec.sub.n_tasks
            client.stats["failed"] += 1
            if self._recoverable:
                self._checkpoint_failed(rec)
            rec.future._fail(exc if isinstance(exc, SubmissionError)
                             else SubmissionError(
                                 f"submission {sub_id} failed: {exc!r}"))
            # partial rank results are dead (sub.blocks stays: ranks that
            # have not assimilated yet still read it off the bus)
            rec.published = {}
            # every rank must learn: skip the sub's queued tasks, poison
            # the namespace versions it will never produce
            self.bus.post(("fail", sub_id))
            self._update_floor()
            self._note_drained(sub_id)
            self._advance_watermark()
            self._cond.notify_all()

    def _advance_watermark(self) -> None:
        # caller holds the lock
        w = self._resolved_through
        while (w + 1) in self._subs and self._subs[w + 1].resolved:
            w += 1
        if w != self._resolved_through:
            # records at or below the watermark are finished everywhere —
            # evict them so frontdoor memory tracks in-flight work, not
            # the stream's history
            evicted = [self._subs.pop(s)
                       for s in range(self._resolved_through + 1, w + 1)]
            self._resolved_through = w
            self.bus.post(("watermark", w))
            if self._recoverable:
                self._ns_ckpt.retire_through(w)
            for rec in evicted:
                # after the watermark: ranks process the drop only once
                # their retired-through covers the sub, so any straggler
                # publish into the dead namespace is discarded, not kept
                if rec.sub.ephemeral:
                    self.bus.post(("drop_ns", rec.sub.namespace))
                    if self._recoverable:
                        self._ns_ckpt.drop_namespace(rec.sub.namespace)
                    self._ns_owner.pop(rec.sub.namespace, None)

    def _update_floor(self) -> None:
        # caller holds the lock; pin the bus trim at the oldest unresolved
        # SUBMIT so adoption replay can always re-read it
        unresolved = [r.bus_pos for r in self._subs.values()
                      if not r.resolved]
        self.bus.set_floor(min(unresolved) if unresolved else None)

    # ----------------------------------------------------- recovery (death)

    def _checkpoint_resolved(self, rec: _SubRecord) -> None:
        # caller holds the lock. Record the resolved submission's durable
        # effect so an adopter can reseed its namespace shard without
        # replaying resolved work: honored seeds and published versions.
        sub = rec.sub
        for blk, val in rec.seeded.items():
            self._ns_ckpt.restore(sub.namespace, blk, (sub.sub_id, 0),
                                  AVAILABLE, val)
        for blk, val in rec.published.items():
            self._ns_ckpt.restore(sub.namespace, blk, (sub.sub_id, 1),
                                  AVAILABLE, val)

    def _checkpoint_failed(self, rec: _SubRecord) -> None:
        # caller holds the lock. A failed submission's poisons must reach
        # the checkpoint even if the owning rank died before reporting
        # them (a reader binding to a lost poison would silently read
        # stale data instead of failing) — so the frontdoor derives the
        # final-write set itself. Failure path only; never on the hot path.
        sub = rec.sub
        try:
            for s in range(self.n_shards):
                view = sub.graph.derive_local(s, sub.owner_map)
                for blk in view.final_writes:
                    self._ns_ckpt.restore(sub.namespace, blk,
                                          (sub.sub_id, 1), POISONED)
        except Exception:
            pass  # checkpointing must never mask the submission failure

    def _note_poisoned(self, sub_id: int, keys) -> None:
        """Rank-side poison report: precise (only versions that were
        actually PENDING on that rank), complementing the frontdoor's
        conservative derivation in ``_checkpoint_failed``."""
        if not self._recoverable or not keys:
            return
        with self._lock:
            for ns, blk in keys:
                self._ns_ckpt.restore(ns, blk, (sub_id, 1), POISONED)

    def _checkpoint_rows(self) -> List[tuple]:
        return self._ns_ckpt.export()

    def _owner_of(self, ns: str) -> Optional[Callable]:
        with self._lock:
            return self._ns_owner.get(ns)

    def _published_so_far(self, sub_id: int) -> dict:
        """Values an *unresolved* submission already published via shards
        that since completed locally and dropped their state — the
        frontdoor record still holds them, and an adopter restores the
        ones it now owns so later binds see them."""
        with self._lock:
            rec = self._subs.get(sub_id)
            return dict(rec.published) if rec is not None else {}

    def _sub_state(self, sub_id: int) -> str:
        with self._lock:
            rec = self._subs.get(sub_id)
            if rec is None:
                return "gone"       # evicted below the watermark
            if not rec.resolved:
                return "unresolved"
            return "failed" if rec.failed else "done"

    def _on_ranks_dead(self, newly, lost_shards) -> None:
        """First survivor to apply a DEATH declaration lands here (the
        others dedup): freeze the dead cursors, re-arm every unresolved
        record's pending set with the lost shards (the adopters will
        re-report them — client futures stay alive across the epoch),
        start the recovery clock, and shrink the elastic membership."""
        with self._cond:
            fresh = [d for d in newly if d not in self._dead_ranks]
            if not fresh:
                return
            self._dead_ranks.update(fresh)
            self._dead_shards.update(lost_shards)
            for d in fresh:
                self.bus.freeze(d)
                if self._elastic is not None:
                    self._elastic.declare_failed(d)
            if self._elastic is not None:
                try:
                    self.elastic_plan = self._elastic.poll(None)
                except Exception:
                    self.elastic_plan = None
            if self._death_t0 is None:
                self._death_t0 = time.monotonic()
                self._inflight_at_death = {
                    s for s, r in self._subs.items() if not r.resolved}
                if not self._inflight_at_death:
                    self.sched_recover_ms = 0.0
            for r in self._subs.values():
                if not r.resolved:
                    r.pending_ranks.update(lost_shards)
            self._cond.notify_all()

    def _note_drained(self, sub_id: int) -> None:
        # caller holds the lock: stamp sched_recover_ms once — DEATH
        # declaration -> every submission in flight at that moment resolved
        if self._inflight_at_death is None \
                or self.sched_recover_ms is not None:
            return
        self._inflight_at_death.discard(sub_id)
        if not self._inflight_at_death:
            self.sched_recover_ms = (time.monotonic()
                                     - self._death_t0) * 1e3
    def _beat(self, rank: int) -> None:
        if self._elastic is not None:
            self._elastic.beat(rank)

    def admit_replacement(self, rank: int) -> None:
        """Announce a replacement host for a dead rank. The in-proc world
        cannot spawn a new rank thread mid-run, so admission is
        control-plane today: the elastic controller re-arms the rank's
        lease, and its first heartbeat emits the grow plan (remesh over
        the proven-alive set). The data plane keeps routing the dead
        rank's shards to their adopters until a remesh migrates them."""
        with self._lock:
            if self._elastic is None:
                from repro_torch.train.elastic import ElasticController
                self._elastic = ElasticController(
                    self.n_shards, chips_per_host=1, model_axis=1)
            self._elastic.admit(rank)

    # --------------------------------------------------------------- stats

    def stats(self) -> dict:
        ranks = [s.to_dict() for s in self.rank_stats if s is not None]
        if not ranks and self.rank_summaries:
            # cross-process ranks: no shared-memory LiveStats — the final
            # summaries (which embed the same counters) stand in once the
            # stream has drained
            ranks = [s for s in self.rank_summaries if isinstance(s, dict)]
        total = sum(r["blocks_total"] for r in ranks)
        hwm = sum(r["blocks_hwm"] for r in ranks)
        with self._lock:
            clients = {n: dict(c.stats) for n, c in self._clients.items()}
        return {
            "ranks": ranks,
            "clients": clients,
            "blocks_total": total,
            "blocks_hwm": hwm,
            "live_frac": (hwm / total) if total else 0.0,
            "resolved_through": self._resolved_through,
            "capacity": self.capacity(),
        }

    def capacity(self) -> dict:
        with self._lock:
            live = self.n_shards - len(self._dead_ranks)
            return {"n_shards": self.n_shards, "live_ranks": live,
                    "dead_ranks": sorted(self._dead_ranks),
                    "dead_shards": sorted(self._dead_shards),
                    "degraded": bool(self._dead_ranks),
                    "sched_recover_ms": self.sched_recover_ms}

    def debug_snapshot(self) -> str:
        """Forensic dump for future timeouts: the bus-cursor picture,
        unresolved submissions and their pending shards, and each live
        rank's serve-loop + protocol state."""
        lines = ["scheduler snapshot:"]
        try:
            lines.append(f"  bus: {self.bus.snapshot()}")
        except Exception as e:
            lines.append(f"  bus: <snapshot failed: {e!r}>")
        with self._lock:
            unresolved = {s: sorted(r.pending_ranks)
                          for s, r in self._subs.items() if not r.resolved}
        lines.append(f"  unresolved (sub -> pending shards): {unresolved}")
        lines.append(f"  capacity: {self.capacity()}")
        # per-rank state travels through the world's snapshot providers (a
        # SNAPSHOT request over the control channel on multiproc — ranks
        # may live in other processes); fall back to the shared-memory
        # runtime handles when no world is attached
        for r in range(self.n_shards):
            snap = None
            if self._world is not None:
                try:
                    snap = self._world.snapshot_rank(r)
                except Exception as e:
                    snap = f"<snapshot failed: {e!r}>"
            if snap is None:
                rt = self._runtimes[r]
                if rt is None:
                    continue
                try:
                    snap = rt.snapshot()
                except Exception as e:
                    snap = f"<snapshot failed: {e!r}>"
            lines.append(f"  rank {r}: {snap}")
        return "\n".join(lines)

    # ------------------------------------------------------------ rank side

    def _rank_main(self, ctx):
        # on a cross-process transport the rank talks to the parent-hosted
        # service/bus through RPC proxies; `self` here is a forked copy
        # whose locks and threads must never be touched
        svc = self
        rpc = getattr(ctx.comm.world, "svc_rpc", None)
        if rpc is not None:
            from .proxy import ServiceProxy
            svc = ServiceProxy(rpc, self.n_shards, self.device)
        rt = ShardRuntime(ctx, svc)
        svc.rank_stats[ctx.rank] = rt.stats
        svc._runtimes[ctx.rank] = rt
        rt.serve()
        ctx.tp.join()   # distributed completion protocol, after STOP
        return rt.summary()


# ------------------------------------------------------------ rank runtime


class ShardRuntime:
    """One resident rank: bus consumption, lazy assimilation, execution —
    for its own shard and any shard it adopts after a death declaration.

    The serve loop pumps ``comm.progress()`` (delivery, acks, retransmits
    — plus the failure-detection half of the completion protocol when
    faults are active, never its quiescence rounds) and applies new bus
    commands; task bodies run on the rank's worker threads as
    fulfillments land. ``route``/``hosted`` mirror ``linalg.host_exec``'s
    fault-tolerant host: shard->rank routing is identical on every rank
    (driven by the DEATH assignment broadcast), misrouted traffic is
    forwarded, and cross-rank sends are logged for replay when their
    destination shard moves.
    """

    def __init__(self, ctx, svc: SchedulerService):
        self.ctx = ctx
        self.rank = ctx.rank
        self.n = svc.n_shards
        self.svc = svc
        self.device = svc.device
        self.stats = LiveStats()
        self.fair = FairPolicy()
        self.ns = NamespaceShard(self.stats)
        # shard -> hosting rank; task->shard (view.mapping) is immutable,
        # only shard->host moves. Guarded by _rlock together with hosted
        # and the send log (workers read the route; reconfigure writes it).
        self.route: List[int] = list(range(self.n))
        self.hosted: set = {self.rank}
        self._rlock = threading.RLock()
        self.subs: Dict[tuple, SubmissionShard] = {}  # (sub_id, shard)
        self.open: set = set()                        # (sub_id, shard)
        self.finished: set = set()
        # guards the finished/open transition: a worker thread (last task
        # completing) and the serve thread (assimilation-time remaining==0
        # after held fulfillments) can race into _local_complete
        self._fin_lock = threading.Lock()
        self.assimilated = 0    # highest sub_id ingested (bus order == id)
        self.cursor = 0
        self.tasks_run = 0
        self._stop = False
        # (sub_id, shard) -> fulfillments that raced ahead of assimilation;
        # the lock closes the lookup-or-hold vs insert-and-drain race that
        # multi-shard hosting introduces (workers deliver locally now)
        self._held_lock = threading.Lock()
        self._held_fulfills: Dict[tuple, list] = {}
        # fetches for readers this rank has not assimilated yet
        self._held_fetches: List[tuple] = []
        # sub_id -> cross-rank sends ("ful"/"pub" entries) to replay if
        # the destination shard moves; fault runs only, pruned at the
        # watermark (a resolved submission's sends can never be needed)
        self._sendlog: Dict[int, List[tuple]] = {}
        self._recover = ctx.comm.world.faults is not None
        self._last_beat = 0.0
        # the dispatcher-AM set: registered once, at rank start, in the
        # same order on every rank (registration order is the AM identity)
        self.am_fulfill = ctx.comm.make_active_msg(self._on_fulfill)
        self.am_fetch = ctx.comm.make_active_msg(self._on_fetch)
        self.am_value = ctx.comm.make_active_msg(self._on_value)
        self.am_publish = ctx.comm.make_active_msg(self._on_publish)
        if self._recover:
            ctx.comm.on_reconfigure = self._reconfigure
        # forensics: serve-loop state overrides the bare comm snapshot the
        # rank session registered (works cross-process: the world routes a
        # SNAPSHOT request here)
        ctx.comm.world.attach_snapshot_provider(ctx.rank, self.snapshot)

    # ------------------------------------------------------------ the loop

    def serve(self) -> None:
        """The serve loop, with a heartbeat thread beside it when faults
        are active: the loop applies every pending bus command before it
        pumps ``progress()`` again, so a rank assimilating a batch of
        submissions (or re-deriving a dead rank's shards) can stay away
        from ``progress()``, where heartbeats are sent, longer than the
        lease, and would be declared dead while alive."""
        stop = threading.Event()
        if self._recover and self.rank != 0:
            threading.Thread(target=self._heartbeats, args=(stop,),
                             name=f"heartbeat-{self.rank}",
                             daemon=True).start()
        try:
            self._serve()
        finally:
            stop.set()

    def _heartbeats(self, stop: threading.Event) -> None:
        """Beat every ``heartbeat_every`` seconds until ``stop``; a killed
        rank falls silent (the world fences its sends too)."""
        comm = self.ctx.comm
        while not stop.wait(comm.world.faults.heartbeat_every):
            if self.rank in comm.world.dead:
                return
            comm.heartbeat()

    def _serve(self) -> None:
        world = self.ctx.comm.world
        while True:
            if self.rank in world.dead:
                # killed mid-stream: fall silent like a crashed process.
                # The frontdoor froze this rank's bus cursor at the DEATH
                # declaration; the adopter replays from there.
                raise RankKilled(f"rank {self.rank} killed while serving")
            if world.poison.is_set():
                raise WorldPoisoned("world poisoned while serving")
            if self._recover:
                self._maybe_beat()
                self.ctx.comm.poll_failure_detector()
            for cmd in self.svc.bus.read_from(self.cursor, self.rank):
                if self.rank in world.dead:
                    raise RankKilled(
                        f"rank {self.rank} killed mid-batch")
                self.cursor += 1
                self._apply(cmd)
            self.ctx.comm.progress()
            if self._stop:
                with self._fin_lock:
                    if not self.open:
                        return
            time.sleep(10e-6)

    def _maybe_beat(self) -> None:
        now = time.monotonic()
        if now - self._last_beat >= 0.05:
            self._last_beat = now
            self.svc._beat(self.rank)

    def _apply(self, cmd: tuple) -> None:
        kind = cmd[0]
        if kind == "submit":
            sub = cmd[1]
            with self._rlock:
                shards = sorted(self.hosted)
            for s in shards:
                self._assimilate(sub, s)
            self.assimilated = sub.sub_id
            self._drain_held_fetches()
        elif kind == "fail":
            self._fail_cmd(cmd[1])
        elif kind == "watermark":
            w = cmd[1]
            self.ns.retire_through(w)
            with self._fin_lock:
                self.finished = {f for f in self.finished if f[0] > w}
            if self._recover:
                with self._rlock:
                    for s in [s for s in self._sendlog if s <= w]:
                        del self._sendlog[s]
        elif kind == "drop_ns":
            self.ns.drop_namespace(cmd[1])
        elif kind == "stop":
            self._stop = True

    def summary(self) -> dict:
        with self._rlock:
            hosted = sorted(self.hosted)
        return {"rank": self.rank, "tasks_run": self.tasks_run,
                "assimilated": self.assimilated, "hosted": hosted,
                "ns_live_versions": self.ns.live_versions(),
                **self.stats.to_dict()}

    def snapshot(self) -> dict:
        """Serve-loop + protocol forensics for ``debug_snapshot``."""
        with self._rlock:
            hosted, route = sorted(self.hosted), list(self.route)
        with self._fin_lock:
            open_ = sorted(self.open)
        try:
            comm = self.ctx.comm.snapshot()
        except Exception as e:
            comm = f"<comm snapshot failed: {e!r}>"
        return {"cursor": self.cursor, "assimilated": self.assimilated,
                "hosted": hosted, "route": route, "open": open_,
                "tasks_run": self.tasks_run,
                "fair": self.fair.snapshot(), "comm": comm}

    # -------------------------------------------------------- assimilation

    def _assimilate(self, sub: Submission, s: int, *,
                    replay: bool = False) -> None:
        owner = sub.owner()
        # the one and only discovery step: owned + halo, never global
        view = sub.graph.derive_local(s, sub.owner_map)
        if replay:
            # per (submission, shard) re-derivation: count the edges here;
            # _adopt records the shard itself once per adoption
            self.ctx.comm.world.report.bump(
                "rederived_edges", view.stats.get("derived_edges", 0))
        tf = self.ctx.taskflow(f"sub{sub.sub_id}@s{s}")
        shard = SubmissionShard(sub, view, tf, self.stats, shard=s)
        shard.adopted = replay

        # wire the per-submission Taskflow before exposing the shard:
        # a concurrent local fulfillment must never find half-set hooks
        weight = self.svc.client_weight(sub.client)

        def indegree(k):
            return (len(view.in_deps(k)) + len(view.external_reads(k))) or 1

        def priority(k):
            shard.mark_ready(k)   # spawn time == entering the ready queue
            return self.fair.priority_for(sub.client, weight, sub.priority)

        tf.set_indegree(indegree)
        tf.set_mapping(lambda k: hash(k) % self.ctx.tp.n_threads)
        tf.set_priority(priority)
        tf.set_task(lambda k: self._run_task(shard, k))

        with self._held_lock:
            self.subs[(sub.sub_id, s)] = shard
        with self._fin_lock:
            self.open.add((sub.sub_id, s))

        # 1. seed initial values for owned blocks (virgin timelines only:
        #    an earlier submission's write is the truth), as the
        #    submission's own copies on the device
        for blk, val in sub.blocks.items():
            if owner(blk) % self.n == s:
                arr = to_store(val, self.device)
                if self.ns.seed_initial(sub.namespace, blk, sub.sub_id, arr):
                    shard.seeded[blk] = arr
        # 2. reserve the versions this submission will write here
        for blk in view.final_writes:
            if owner(blk) % self.n == s:
                self.ns.ensure_pending(sub.namespace, blk, sub.sub_id)
        if replay:
            # values this submission already published through shards that
            # completed-and-dropped before the death: the frontdoor record
            # still holds them — restore the ones this shard now owns
            for blk, val in self.svc._published_so_far(sub.sub_id).items():
                if owner(blk) % self.n == s:
                    self.ns.restore(sub.namespace, blk, (sub.sub_id, 1),
                                    AVAILABLE, to_store(val, self.device))

        # 3. bind external reads + release seeds (a bad binding fails the
        #    submission, but assimilation always finalizes: the cursor and
        #    held-fetch draining must advance regardless)
        if self._bind_external(shard, owner):
            # seeds: tasks with no dependencies at all (synthetic indegree
            # 1, fulfilled here — execution may start immediately)
            for k in view.tasks:
                if not view.in_deps(k) and not view.external_reads(k):
                    tf.fulfill_promise(k)
            # fulfillments that arrived before this shard existed here
            with self._held_lock:
                held = self._held_fulfills.pop((sub.sub_id, s), [])
            for (d, k, blk, payload) in held:
                self._apply_fulfill(shard, d, k, blk, payload)
        else:
            with self._held_lock:
                self._held_fulfills.pop((sub.sub_id, s), None)
        if not shard.failed and shard.remaining == 0:
            self._local_complete(shard)

    def _bind_external(self, shard: SubmissionShard, owner) -> bool:
        """Bind the view's external reads: blocks whose owner shard is
        hosted here straight from this rank's namespace shard, remote ones
        via one FETCH per block along the current route."""
        sub, view = shard.sub, shard.view
        remote: Dict[B, List[K]] = {}
        with self._rlock:
            hosted = set(self.hosted)
        for k in view.tasks:
            for blk in view.external_reads(k):
                ob = owner(blk) % self.n
                if ob in hosted:
                    try:
                        self.ns.bind(sub.namespace, blk, sub.sub_id,
                                     self._bind_cb(shard, blk, [k]))
                    except KeyError as e:
                        self._fail_local(shard, SubmissionError(str(e)))
                        return False
                else:
                    remote.setdefault(blk, []).append(k)
        with shard.lock:
            shard.fetch_waiters.update(remote)
        for blk in remote:
            self._send_fetch(sub.namespace, blk, owner(blk) % self.n,
                             sub.sub_id, shard.shard)
        return True

    def _bind_cb(self, shard: SubmissionShard, blk: B, ks: List[K]):
        def cb(value, poisoned):
            if poisoned:
                self._fail_local(shard, SubmissionError(
                    f"submission {shard.sub.sub_id}: upstream submission "
                    f"failed before producing block {blk!r}"))
                return
            shard.put(blk, value)
            for k in ks:
                shard.tf.fulfill_promise(k)
        return cb

    # ----------------------------------------------------------- execution

    def _run_task(self, shard: SubmissionShard, k: K) -> None:
        if shard.failed:
            return   # sub already failed: don't run, don't propagate
        view = shard.view
        try:
            shard.mark_running(k)
            with shard.lock:
                ops = [shard.store[b] for b in view.operands(k)]
            # a result on another device raises here: it fails this
            # submission, never the stream
            out = as_block(shard.sub.bodies[view.type_of(k)](*ops),
                           self.device)
        except BaseException as e:
            self._fail_local(shard, e)
            return
        if shard.adopted:
            self.ctx.comm.world.report.bump("reexecuted_tasks")
        blk = view.block_of(k)
        shard.put(blk, out)
        payload_to = view.payload_consumers(k)
        n_remote = 0
        sub_id = shard.sub.sub_id
        for d in view.out_deps(k):
            ds = view.mapping(d) % self.n
            if ds == shard.shard:
                shard.tf.fulfill_promise(d)
            else:
                n_remote += 1
                self._deliver_fulfill(sub_id, ds, d, k, blk,
                                      out if d in payload_to else None)
        if view.final_writes.get(blk) == k:
            self._publish(shard, blk, out)
        self.tasks_run += 1
        if shard.complete(k, n_remote):
            self._local_complete(shard)

    def _deliver_fulfill(self, sub_id: int, ds: int, d: K, k: K, blk: B,
                         payload) -> None:
        """Route one cross-shard fulfillment (and log it for replay)."""
        with self._rlock:
            if self._recover:
                self._sendlog.setdefault(sub_id, []).append(
                    ("ful", ds, d, k, blk, payload))
            tgt = self.route[ds]
        if tgt == self.rank:
            self._local_fulfill(sub_id, ds, d, k, blk, payload)
        else:
            self.am_fulfill.send(tgt, sub_id, ds, d, k, blk, payload)

    def _local_fulfill(self, sub_id: int, ds: int, d: K, k: K, blk: B,
                       payload) -> None:
        with self._held_lock:
            shard = self.subs.get((sub_id, ds))
            if shard is None:
                if sub_id > self.assimilated:
                    self._held_fulfills.setdefault((sub_id, ds), []).append(
                        (d, k, blk, payload))
                return   # finished or failed: late traffic is inert
        self._apply_fulfill(shard, d, k, blk, payload)

    def _apply_fulfill(self, shard: SubmissionShard, d: K, k: K, blk: B,
                       payload) -> None:
        # exactly once per (consumer, producer) edge: transport dedup
        # stops retransmits, but adoption re-execution and send-log replay
        # legitimately re-produce the same fulfillment
        with shard.lock:
            if (d, k) in shard.applied:
                return
            shard.applied.add((d, k))
        if payload is not None:
            shard.put(blk, as_block(payload, self.device))
        shard.tf.fulfill_promise(d)

    def _publish(self, shard: SubmissionShard, blk: B, out) -> None:
        sub = shard.sub
        with shard.lock:
            shard.published[blk] = out
        ob = sub.owner()(blk) % self.n
        with self._rlock:
            hosted = ob in self.hosted
            if hosted:
                tgt = self.rank
            else:
                if self._recover:
                    self._sendlog.setdefault(sub.sub_id, []).append(
                        ("pub", ob, sub.namespace, blk, sub.sub_id, out))
                tgt = self.route[ob]
        if hosted:
            self.ns.publish(sub.namespace, blk, sub.sub_id, out)
        else:
            self.am_publish.send(tgt, sub.namespace, blk, sub.sub_id, ob,
                                 out)

    def _local_complete(self, shard: SubmissionShard) -> None:
        key = (shard.sub.sub_id, shard.shard)
        with self._fin_lock:
            if key in self.finished:
                return
            self.open.discard(key)
            self.finished.add(key)
        with shard.lock:
            published = dict(shard.published)
            seeded = dict(shard.seeded)
        n_bytes = sum(v.nbytes for v in published.values())
        self.svc._rank_done(shard.sub.sub_id, shard.shard, published,
                            n_bytes, seeded=seeded, rank=self.rank)
        shard.drop()
        self.subs.pop(key, None)   # forget the submission: O(frontier)

    # ------------------------------------------------------------- failure

    def _fail_local(self, shard: SubmissionShard,
                    exc: BaseException) -> None:
        sub_id = shard.sub.sub_id
        with shard.lock:
            if shard.failed:
                return
            shard.failed = True
        key = (sub_id, shard.shard)
        with self._fin_lock:
            self.open.discard(key)
            self.finished.add(key)
        self.svc._fail_submission(sub_id, exc)
        self.svc._note_poisoned(sub_id, self.ns.poison_sub(sub_id))
        shard.drop()
        self.subs.pop(key, None)

    def _fail_cmd(self, sub_id: int) -> None:
        with self._rlock:
            shards = sorted(self.hosted)
        for s in shards:
            shard = self.subs.get((sub_id, s))
            if shard is not None:
                with shard.lock:
                    shard.failed = True
                with self._fin_lock:
                    self.open.discard((sub_id, s))
                    self.finished.add((sub_id, s))
                shard.drop()
                self.subs.pop((sub_id, s), None)
        self.svc._note_poisoned(sub_id, self.ns.poison_sub(sub_id))
        if self._recover:
            with self._rlock:
                self._sendlog.pop(sub_id, None)

    # ------------------------------------------------------- active messages

    def _on_fulfill(self, sub_id: int, ds: int, d: K, k: K, blk: B,
                    payload) -> None:
        with self._rlock:
            hosted = ds in self.hosted
        if not hosted:
            # stale route: a survivor's replay raced ahead of our own
            # DEATH processing. Forward along our route — _deliver_fulfill
            # logs the forward, so if our route is itself stale (the
            # fenced dead rank), our reconfigure replays it.
            self.ctx.comm.world.report.bump("forwarded_ams")
            self._deliver_fulfill(sub_id, ds, d, k, blk, payload)
            return
        self._local_fulfill(sub_id, ds, d, k, blk, payload)

    def _send_fetch(self, ns: str, blk: B, ob: int, reader_sub: int,
                    ds: int) -> None:
        with self._rlock:
            hosted = ob in self.hosted
            tgt = self.route[ob]
        if hosted:
            self._on_fetch(ns, blk, ob, reader_sub, ds, self.rank)
        else:
            self.am_fetch.send(tgt, ns, blk, ob, reader_sub, ds, self.rank)

    def _on_fetch(self, ns: str, blk: B, ob: int, reader_sub: int,
                  ds: int, src: int) -> None:
        with self._rlock:
            hosted = ob in self.hosted
            tgt = self.route[ob]
            if not hosted and self._recover:
                # a fetch forwarded into a stale route (the fenced dead
                # rank) would strand its reader: log it like a fulfill so
                # our own reconfigure replays it once the shard is re-homed
                self._sendlog.setdefault(reader_sub, []).append(
                    ("fet", ob, ns, blk, reader_sub, ds, src))
        if not hosted:
            self.ctx.comm.world.report.bump("forwarded_ams")
            self.am_fetch.send(tgt, ns, blk, ob, reader_sub, ds, src)
            return
        if reader_sub > self.assimilated:
            # binding needs every version with key < (reader_sub, 1) in
            # the timeline — hold until this rank's cursor catches up
            self._held_fetches.append((ns, blk, ob, reader_sub, ds, src))
            return

        def cb(value, poisoned):
            if src == self.rank:   # post-adoption self-fetch
                self._on_value(reader_sub, ds, blk, value, poisoned)
            else:
                self.am_value.send(src, reader_sub, ds, blk, value,
                                   poisoned)
        try:
            self.ns.bind(ns, blk, reader_sub, cb)
        except KeyError:
            cb(None, True)

    def _drain_held_fetches(self) -> None:
        held, self._held_fetches = self._held_fetches, []
        for args in held:
            self._on_fetch(*args)

    def _on_value(self, reader_sub: int, ds: int, blk: B, value,
                  poisoned) -> None:
        with self._held_lock:
            shard = self.subs.get((reader_sub, ds))
        if shard is None:
            return
        if poisoned:
            self._fail_local(shard, SubmissionError(
                f"submission {reader_sub}: upstream submission failed "
                f"before producing block {blk!r}"))
            return
        with shard.lock:
            ks = shard.fetch_waiters.pop(blk, [])
        if not ks:
            return   # duplicate value: a re-issued fetch raced the original
        shard.put(blk, as_block(value, self.device))
        for k in ks:
            shard.tf.fulfill_promise(k)

    def _on_publish(self, ns: str, blk: B, sub_id: int, ob: int,
                    value) -> None:
        with self._rlock:
            hosted = ob in self.hosted
            if not hosted:
                if self._recover:
                    self._sendlog.setdefault(sub_id, []).append(
                        ("pub", ob, ns, blk, sub_id, value))
                tgt = self.route[ob]
        if not hosted:
            self.ctx.comm.world.report.bump("forwarded_ams")
            self.am_publish.send(tgt, ns, blk, sub_id, ob, value)
            return
        self.ns.publish(ns, blk, sub_id, as_block(value, self.device))

    # ------------------------------------------------------------ recovery

    def _reconfigure(self, newly_dead, assignment, epoch) -> None:
        """DEATH declaration applied (runs on this rank's serve thread,
        inside ``progress()``): freeze the dead cursors and re-arm the
        frontdoor, adopt what is ours (checkpoint restore + bus replay),
        flip the routes, replay logged sends to every moved shard, and
        re-issue outstanding fetches whose owner moved."""
        report = self.ctx.comm.world.report
        dead = set(newly_dead)
        with self._rlock:
            old_route = list(self.route)
        # the DEATH assignment keys dead ranks — which ARE shard ids (shard
        # s starts on rank s, and the cumulative map re-states every dead
        # rank's shard each epoch), same reading as linalg's _FaultHost
        changed = {s: h for s, h in assignment.items()
                   if old_route[s] != h}
        # shards lost with the newly dead ranks (their pre-flip host just
        # died): the frontdoor re-arms exactly these in pending sets
        lost = [s for s in range(self.n) if old_route[s] in dead]
        mine: Dict[int, List[int]] = {}
        for s, h in changed.items():
            if h == self.rank:
                mine.setdefault(old_route[s], []).append(s)
        self.svc._on_ranks_dead(newly_dead, lost)
        for dead_host, shards in sorted(mine.items()):
            self._adopt(dead_host, sorted(shards), report)
        # adoption wired the shards into `hosted` BEFORE this flip: a route
        # that says "me" must always find its state
        with self._rlock:
            for s, h in changed.items():
                self.route[s] = h
            entries = [(sid, e) for sid, log in self._sendlog.items()
                       for e in log if e[1] in changed]
        for sid, e in entries:
            self._replay_send(sid, e, report)
        self._refetch(set(changed))
        # lift the dead cursors' trim pins. Each adopter votes once per
        # dead host it adopted from; the pin holds until the LAST adopter
        # has replayed (one dead rank's shards can land on several
        # survivors). Vote counts agree on every rank: they derive from
        # the broadcast assignment and the deterministic pre-flip route.
        adopters: Dict[int, set] = {}
        for s, h in changed.items():
            if old_route[s] in dead:
                adopters.setdefault(old_route[s], set()).add(h)
        for dead_host, who in adopters.items():
            if self.rank in who:
                self.svc.bus.retire_reader(dead_host,
                                           votes_needed=len(who))

    def _adopt(self, dead_host: int, shards: List[int], report) -> None:
        """Adopt ``shards`` lost with ``dead_host``: reseed the namespace
        from the frontdoor's resolved-prefix checkpoint, then replay the
        bus from the dead rank's frozen cursor (floored at the oldest
        unresolved SUBMIT), re-deriving unresolved submissions for the
        adopted shards. Every effect is idempotent, so over-covering the
        dead rank's actually-applied prefix is safe."""
        shard_set = set(shards)
        for ns, blk, key, state, value in self.svc._checkpoint_rows():
            owner = self.svc._owner_of(ns)
            if owner is None or owner(blk) % self.n not in shard_set:
                continue
            self.ns.restore(ns, blk, key, state, value)
        lo = self.svc.bus.frozen_cursor(dead_host)
        floor = self.svc.bus.floor()
        if floor is not None:
            lo = min(lo, floor)
        # host the shards before replaying: replay-time assimilation must
        # bind the adopted shard's own blocks locally, not fetch them from
        # the pre-flip route (the fenced dead rank)
        with self._rlock:
            self.hosted.update(shards)
        for s in shards:
            report.note_rederived(s, 0)
        for cmd in self.svc.bus.read_range(lo, self.cursor):
            report.bump("bus_replayed")
            self._replay_cmd(cmd, shards)

    def _replay_cmd(self, cmd: tuple, shards: List[int]) -> None:
        kind = cmd[0]
        if kind == "submit":
            sub = cmd[1]
            if self.svc._sub_state(sub.sub_id) == "unresolved":
                for s in shards:
                    self._assimilate(sub, s, replay=True)
            # resolved (done or failed) or evicted: its durable effect —
            # publishes, honored seeds, poisons — was restored from the
            # frontdoor checkpoint before replay began
        elif kind == "fail":
            self.ns.poison_sub(cmd[1])
        elif kind == "watermark":
            self.ns.retire_through(cmd[1])
        elif kind == "drop_ns":
            self.ns.drop_namespace(cmd[1])
        # stop: this rank's own cursor already tracked it

    def _replay_send(self, sub_id: int, e: tuple, report) -> None:
        report.bump("replayed_sends")
        if e[0] == "ful":
            _, ds, d, k, blk, payload = e
            self._deliver_fulfill(sub_id, ds, d, k, blk, payload)
        elif e[0] == "fet":
            _, ob, ns, blk, reader_sub, ds, src = e
            self._on_fetch(ns, blk, ob, reader_sub, ds, src)
        else:
            _, ob, ns, blk, sid, value = e
            with self._rlock:
                hosted = ob in self.hosted
                tgt = self.route[ob]
            if hosted:
                self.ns.publish(ns, blk, sid, value)
            else:
                self.am_publish.send(tgt, ns, blk, sid, ob, value)

    def _refetch(self, changed: set) -> None:
        """Outstanding fetches whose owner shard just moved: the fetch (or
        its value) may have died with the old host — re-issue along the
        new route. Duplicate values are absorbed by the empty-waiters
        guard in ``_on_value``; bindings are deterministic, so a
        duplicate carries the identical value anyway."""
        with self._held_lock:
            live = list(self.subs.items())
        for (sub_id, s), shard in live:
            owner = shard.sub.owner()
            with shard.lock:
                waiting = list(shard.fetch_waiters.keys())
            for blk in waiting:
                ob = owner(blk) % self.n
                if ob in changed:
                    self._send_fetch(shard.sub.namespace, blk, ob,
                                     sub_id, s)
