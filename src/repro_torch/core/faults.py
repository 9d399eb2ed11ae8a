"""Fault injection plans and recovery accounting for the host runtime (the
port's copy of the JAX package's ``repro.core.faults``; pure Python).

The in-proc world (:mod:`repro_torch.core.messages`) emulates the transport; a
:class:`FaultPlan` makes it *adversarial in the failure dimension* the way
``delay_fn`` already makes it adversarial in the ordering dimension:

- per-edge message **drop** and **duplication** probabilities, driven by a
  seeded per-``(src, dst)`` RNG so every schedule is reproducible;
- **rank kills** — ``kill={rank: at_msg}`` silences ``rank`` the moment it
  tries to queue its ``at_msg``-th user AM: the send is dropped, every
  undelivered message from that rank is purged, and the rank never sends or
  receives again (a crashed process, not a slow one);
- the failure-detector knobs (heartbeat period, lease) and the reliable
  layer's retry schedule.

:class:`RecoveryReport` is the measurement half — robustness is measured,
not just asserted: every injected fault, transport retry, suppressed
duplicate, declared death, re-derived shard, replayed send, and re-executed
task is counted, with ``recovery_seconds`` and ``rederived_frac``.
All mutators are lock-guarded: workers, progress threads, and the world all
write into one report.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic, seeded description of the faults to inject.

    ``drop`` / ``duplicate`` apply independently to every wire message
    (user AMs, protocol traffic, and transport acks alike — the reliable
    layer must survive all of it). ``kill`` maps rank -> the 1-based user-AM
    send count at which the rank dies mid-send. Rank 0 is the completion /
    failure arbiter and cannot be killed (the paper's rank-0 asymmetry;
    arbiter election is out of scope).
    """

    seed: int = 0
    drop: float = 0.0
    duplicate: float = 0.0
    kill: Dict[int, int] = field(default_factory=dict)
    # failure detector: heartbeat period and lease (silence -> declared dead)
    heartbeat_every: float = 0.02
    lease: float = 0.5
    # reliable layer: retransmit after retry_base * 2**attempt (capped),
    # SUSPECT the destination after retry_budget unacked attempts
    retry_base: float = 0.03
    retry_budget: int = 8

    def __post_init__(self):
        if 0 in self.kill:
            raise ValueError("rank 0 is the arbiter and cannot be killed")
        if not (0.0 <= self.drop < 1.0 and 0.0 <= self.duplicate < 1.0):
            raise ValueError("drop/duplicate must be probabilities in [0, 1)")

    def edge_rng(self, src: int, dst: int) -> random.Random:
        """Independent deterministic stream per directed edge."""
        return random.Random(f"{self.seed}:{src}->{dst}")


class RecoveryReport:
    """Thread-safe tally of injected faults and the runtime's response."""

    _COUNTERS = (
        "injected_drops", "injected_dups", "retries", "dup_suppressed",
        "replayed_sends", "reexecuted_tasks", "rederived_edges",
        "forwarded_ams", "bus_replayed",
    )

    def __init__(self, total_edges: Optional[int] = None):
        self._lock = threading.Lock()
        for c in self._COUNTERS:
            setattr(self, c, 0)
        self.suspects: List[int] = []
        self.deaths: List[int] = []
        self.rederived_shards: List[int] = []
        self.total_edges = total_edges
        self.recovery_seconds: Optional[float] = None
        self._death_declared_at: Optional[float] = None

    def __getstate__(self) -> dict:
        # the report crosses process boundaries on the multiproc transport
        # (each rank ships its tally home for merging): drop the lock
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def bump(self, counter: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def note_suspect(self, rank: int) -> None:
        with self._lock:
            if rank not in self.suspects:
                self.suspects.append(rank)

    def note_death(self, rank: int, now: float) -> None:
        with self._lock:
            if rank not in self.deaths:
                self.deaths.append(rank)
                if self._death_declared_at is None:
                    self._death_declared_at = now

    def note_rederived(self, shard: int, edges: int) -> None:
        with self._lock:
            self.rederived_shards.append(shard)
            self.rederived_edges += edges

    def note_recovered(self, now: float) -> None:
        """Stamp recovery_seconds once: first death -> back to quiescence."""
        with self._lock:
            if self._death_declared_at is not None and \
                    self.recovery_seconds is None:
                self.recovery_seconds = now - self._death_declared_at

    @property
    def rederived_frac(self) -> Optional[float]:
        """Re-derived edge entries / full eager edge entries (the lazy-
        discovery payoff: should track halo-sized, not O(global))."""
        if not self.total_edges:
            return None
        return self.rederived_edges / self.total_edges

    def to_dict(self) -> dict:
        d = {c: getattr(self, c) for c in self._COUNTERS}
        d.update(
            suspects=list(self.suspects),
            deaths=list(self.deaths),
            rederived_shards=list(self.rederived_shards),
            total_edges=self.total_edges,
            recovery_seconds=self.recovery_seconds,
            rederived_frac=self.rederived_frac,
        )
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"RecoveryReport({self.to_dict()!r})"
