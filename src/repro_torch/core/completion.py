"""Distributed completion detection — §II-B3 of the paper — extended with
membership: a lease-based failure detector and death declaration.

The difficulty: all taskflows being idle does *not* imply termination — AMs
may still be in flight, and a naive all-ranks-idle signal terminates early.
The paper's protocol (with correctness proof, Lemma 1 + Theorems 1-2):

every rank r tracks monotone counters ``q_r`` (user AMs queued) and ``p_r``
(user AMs processed); protocol messages are excluded from both.

1. COUNT        — when rank r's worker pool is idle and (q_r, p_r) differ
                  from the last values it sent, r sends (r, q_r, p_r) to 0.
2. REQUEST      — rank 0 keeps the *latest* counts per rank (they are
                  monotone, so greatest wins; stale ones are discarded).
                  When Σq == Σp and that sum differs from the last sum it
                  requested on, it sends (q_r, p_r, t̃) back to every rank,
                  echoing each rank's own counts, with a strictly increasing
                  integer tag t̃ (the synchronization time).
3. CONFIRMATION — rank r processes the REQUEST with the largest t̃ only; if
                  its counts are *unchanged* from the echoed ones (and its
                  workers are still idle), it replies (t̃).
4. SHUTDOWN     — once every rank confirmed the latest t̃ (rank 0 checking
                  itself directly), completion is certain: rank 0 broadcasts
                  SHUTDOWN.
5. ranks terminate on SHUTDOWN.

The two-phase check (COUNT then CONFIRMATION around the same t̃) is exactly
what Lemma 1 needs: counts stable across a synchronization time with equal
global sums ⇒ every queued message was processed ⇒ quiescence is permanent.

**Membership extension** (active when the world carries a
:class:`~repro_torch.core.faults.FaultPlan`): every non-0 rank heartbeats rank 0
from its progress loop; rank 0 feeds a
:class:`~repro_torch.train.elastic.HeartbeatMonitor` (the same lease logic the
elastic trainer uses at host granularity), on a clock that runs only while
rank 0 reads its inbox (``on_poll``), and, when a lease expires,
*declares* the silent rank dead:

- the quiescence state moves to a new **epoch**; every protocol message
  carries its epoch, and stale-epoch COUNT/REQUEST/CONFIRMATION traffic is
  discarded (the one-shot counter adjustment at a death breaks cross-epoch
  monotonicity, so the fence is what keeps "greatest wins" sound);
- a DEATH message — (epoch, cumulative dead set, shard→adopter assignment)
  — is broadcast reliably to the survivors; it is idempotent and
  order-safe, so duplicated or reordered declarations converge;
- each survivor applies the death: physically fences the dead rank
  (``world.kill`` is idempotent), subtracts the dead rank's share from its
  effective counters (``Communicator.drop_rank_counts``), resets its
  per-epoch protocol state, and hands the assignment to the runtime's
  ``on_reconfigure`` hook (shard adoption + send replay; see
  ``linalg.host_exec``);
- the protocol then re-runs over the survivor set: Σq == Σp over survivors
  again implies permanent quiescence, because reliable delivery guarantees
  every survivor→survivor user AM is processed exactly once and the dead
  rank's traffic is excluded on both sides of the ledger.

Rank 0 is the arbiter and cannot die (FaultPlan enforces it) — the same
asymmetry the paper's protocol already has.

The port's copy of the JAX package's ``repro.core.completion``, equal in
behaviour (its lease monitor is the port's own ``train.elastic``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .messages import Communicator
from ..train.elastic import HeartbeatMonitor

COUNT, REQUEST, CONFIRMATION, SHUTDOWN = "COUNT", "REQUEST", "CONFIRMATION", "SHUTDOWN"
DEATH = "DEATH"


@dataclass
class _Rank0State:
    latest: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    tilde_t: int = 0
    last_requested_sum: Optional[int] = None
    requested: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    confirmations: set = field(default_factory=set)
    sent_shutdown: bool = False


class CompletionDetector:
    """Drives the §II-B3 protocol for one rank; ``step()`` runs inside the
    main thread's progress loop ("continuously")."""

    def __init__(self, comm: Communicator):
        self.comm = comm
        self.rank = comm.rank
        self.n_ranks = comm.n_ranks
        self.epoch = 0
        self.alive = set(range(self.n_ranks))
        self.dead: set = set()
        self._last_sent: Optional[Tuple[int, int]] = None
        # REQUEST handling (all ranks, incl. 0 via direct path)
        self._pending_request: Optional[Tuple[int, Tuple[int, int]]] = None
        self._confirmed_tilde: int = -1
        self._r0 = _Rank0State() if self.rank == 0 else None
        # failure detection (rank 0, only under a FaultPlan)
        plan = comm.world.faults
        self._monitor: Optional[HeartbeatMonitor] = None
        if self.rank == 0 and plan is not None:
            self._monitor = HeartbeatMonitor(self.n_ranks,
                                             dead_after=plan.lease)
            self._beat_every = plan.heartbeat_every
        # rank 0's listening clock (see on_poll): the leases' time base
        self._listened = 0.0
        self._polled_at: Optional[float] = None
        comm.attach_detector(self)

    # ----------------------------------------------------------- inbound

    def on_heartbeat(self, src: int) -> None:
        if self._monitor is not None:
            self._monitor.beat(src, self._listened)

    def on_poll(self) -> None:
        """Rank 0 is about to read its inbox: advance its listening clock
        by the time since its last read, but by one heartbeat period at
        most. Leases run on this clock, so silence is charged only while
        rank 0 listens: beats waiting unread while rank 0 was kept from
        ``progress()``, or not yet sent by ranks paused with it (a garbage
        collection, a descheduled process), make no rank look dead."""
        if self._monitor is None:
            return
        now = time.monotonic()
        if self._polled_at is not None:
            self._listened += min(now - self._polled_at, self._beat_every)
        self._polled_at = now

    def on_message(self, wire) -> None:
        if wire.kind == DEATH:
            epoch, dead, assignment = wire.meta
            if epoch > self.epoch:
                self._apply_death(epoch, set(dead), dict(assignment))
            return
        if wire.kind == SHUTDOWN:
            self.comm.shutdown.set()
            return
        epoch = wire.meta[0]
        if epoch != self.epoch:
            return  # stale-epoch protocol traffic is fenced out
        if wire.kind == COUNT:
            r, q, p = wire.meta[1:]
            prev = self._r0.latest.get(r)
            if prev is None or (q, p) > prev:  # monotone: keep greatest
                self._r0.latest[r] = (q, p)
        elif wire.kind == REQUEST:
            counts, tilde_t = wire.meta[1:]
            if self._pending_request is None or tilde_t > self._pending_request[0]:
                self._pending_request = (tilde_t, counts)  # largest t̃ wins
        elif wire.kind == CONFIRMATION:
            tilde_t = wire.meta[1]
            if tilde_t == self._r0.tilde_t and wire.src in self.alive:
                self._r0.confirmations.add(wire.src)

    # ------------------------------------------------------------- driver

    def step(self) -> None:
        self._step_failures()
        self._step_count()
        self._step_confirm()
        if self.rank == 0:
            self._step_rank0()

    def poll_failures(self) -> None:
        """Failure detection *only* — no COUNT/REQUEST rounds. The resident
        scheduler's serve loop calls this: it must declare deaths between
        submissions, but must never run the quiescence steps, which would
        tear the world down at the first idle moment of the stream."""
        self._step_failures()

    def _counts(self) -> Tuple[int, int]:
        return self.comm.effective_counts()

    def _step_count(self) -> None:
        """Step 1: idle + changed counts -> COUNT to rank 0 (t_r^-)."""
        if not self.comm.worker_idle():
            return
        counts = self._counts()
        if counts != self._last_sent:
            self._last_sent = counts
            if self.rank == 0:
                self.on_message(_wire(COUNT, 0, (self.epoch, 0, *counts)))
            else:
                self.comm.protocol_send(0, COUNT, (self.epoch, self.rank,
                                                   *counts))

    def _step_confirm(self) -> None:
        """Step 3: largest-t̃ REQUEST; counts unchanged at t_r^+ -> CONFIRM."""
        if self._pending_request is None:
            return
        tilde_t, echoed = self._pending_request
        if tilde_t <= self._confirmed_tilde:
            return
        if self.comm.worker_idle() and self._counts() == echoed:
            self._confirmed_tilde = tilde_t
            if self.rank == 0:
                self._r0.confirmations.add(0)
            else:
                self.comm.protocol_send(0, CONFIRMATION,
                                        (self.epoch, tilde_t))

    def _step_rank0(self) -> None:
        r0 = self._r0
        if r0.sent_shutdown:
            return
        # Step 4: all live ranks confirmed the latest t̃ -> SHUTDOWN.
        if r0.tilde_t > 0 and self.alive <= r0.confirmations:
            r0.sent_shutdown = True
            self.comm.world.report.note_recovered(time.monotonic())
            for r in sorted(self.alive - {0}):
                self.comm.protocol_send(r, SHUTDOWN, (self.epoch,))
            self.comm.shutdown.set()
            return
        # Step 2: sums equal & new -> REQUEST(t̃) with echoed counts.
        if not self.alive <= set(r0.latest):
            return
        sum_q = sum(r0.latest[r][0] for r in self.alive)
        sum_p = sum(r0.latest[r][1] for r in self.alive)
        if sum_q != sum_p:
            return
        snapshot = {r: r0.latest[r] for r in self.alive}
        if snapshot == r0.requested and r0.last_requested_sum == sum_q:
            return  # nothing new since the last REQUEST round
        r0.tilde_t += 1
        r0.last_requested_sum = sum_q
        r0.requested = snapshot
        r0.confirmations = set()
        for r in sorted(self.alive - {0}):
            self.comm.protocol_send(r, REQUEST,
                                    (self.epoch, snapshot[r], r0.tilde_t))
        # rank 0 "receives" its own request directly
        self._pending_request = (r0.tilde_t, snapshot[0])

    # ----------------------------------------------------- failure handling

    def _step_failures(self) -> None:
        """Rank-0 lease check: declare silent ranks dead (one epoch bump per
        declaration round, cumulative dead set, full adoption assignment)."""
        if self._monitor is None:
            return
        now = time.monotonic()
        self._monitor.beat(0, self._listened)
        # Physical deaths are authoritative (the in-proc world fences a
        # killed rank instantly; a real transport would surface connection
        # loss the same way). Lease expiry applies only to ranks heard from
        # at least once: a slow-starting rank that has never beaten is not
        # "silent", it is not up yet — COUNT/AM traffic also counts as a
        # beat (see Communicator.progress), so liveness credit does not
        # depend on the heartbeat path alone.
        phys = [r for r in sorted(self.comm.world.dead)
                if r not in self.dead and r != 0]
        lease = [r for r in self._monitor.dead_hosts(self._listened)
                 if r in self._monitor.last_seen
                 and r not in self.dead and r != 0]
        newly = sorted(set(phys) | set(lease))
        if not newly:
            return
        dead = self.dead | set(newly)
        alive = set(range(self.n_ranks)) - dead
        assignment = {d: _adopter(d, alive, self.n_ranks)
                      for d in sorted(dead)}
        epoch = self.epoch + 1
        for d in newly:
            self.comm.world.report.note_death(d, now)
        for r in sorted(alive - {0}):
            self.comm.protocol_send(
                r, DEATH, (epoch, tuple(sorted(dead)), assignment))
        self._apply_death(epoch, dead, assignment)

    def _apply_death(self, epoch: int, dead: set, assignment: dict) -> None:
        """Apply a (possibly duplicated/reordered) death declaration: fence,
        adjust counters, reset per-epoch protocol state, hand the adoption
        assignment to the runtime. Idempotent per epoch."""
        newly = sorted(dead - self.dead)
        self.dead |= dead
        self.alive -= dead
        self.epoch = epoch
        now = time.monotonic()
        for d in newly:
            self.comm.world.kill(d)  # idempotent physical fence
            self.comm.world.report.note_death(d, now)
        self.comm.drop_rank_counts(newly)
        # per-epoch protocol state restarts over the survivor set
        self._last_sent = None
        self._pending_request = None
        if self._r0 is not None:
            self._r0.latest.clear()
            self._r0.requested = {}
            self._r0.last_requested_sum = None
            self._r0.confirmations = set()
        if self.comm.on_reconfigure is not None:
            self.comm.on_reconfigure(newly, dict(assignment), epoch)

    # ---------------------------------------------------------- diagnostics

    def snapshot(self) -> dict:
        snap = {
            "epoch": self.epoch,
            "alive": sorted(self.alive),
            "dead": sorted(self.dead),
            "last_count_sent": self._last_sent,
            "confirmed_tilde": self._confirmed_tilde,
            "pending_request": self._pending_request,
        }
        if self._r0 is not None:
            snap["rank0"] = {
                "tilde_t": self._r0.tilde_t,
                "latest": dict(self._r0.latest),
                "confirmations": sorted(self._r0.confirmations),
                "sent_shutdown": self._r0.sent_shutdown,
            }
        return snap


def _adopter(dead_rank: int, alive: set, n_ranks: int) -> int:
    """Deterministic adoption: the next live rank cyclically after the dead
    one — every survivor computes the same map from the same DEATH payload."""
    for off in range(1, n_ranks + 1):
        cand = (dead_rank + off) % n_ranks
        if cand in alive:
            return cand
    raise RuntimeError("no live ranks to adopt shards")


def _wire(kind, src, meta):
    from .messages import _Wire

    return _Wire(kind, src, meta=meta)
