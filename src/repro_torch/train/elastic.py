"""Elastic training control: heartbeats, straggler detection, re-mesh (the
port's copy of the JAX package's ``repro.train.elastic``; pure Python).

The host runtime's failure detector (``core.completion``) uses
:class:`HeartbeatMonitor`; the rest serves the training loop, which the
port has not taken up yet.

At 1000+ nodes, failures are routine. The control loop here is
host-level (it orchestrates compiled steps; it is not inside a step):

  heartbeat  — every host reports (step, wall_time) each step; a host
               silent for `dead_after` seconds is declared failed.
  straggler  — persistent per-step outliers (> `straggler_factor` × the
               rolling median for `patience` consecutive steps) are flagged
               for replacement/drain — the cluster-granularity version of
               the paper's work stealing (within a compiled step the
               schedule is static; between steps, placement is ours).
  re-mesh    — on failure: drop to the survivor set, rebuild the mesh,
               restore the latest checkpoint re-sharded to the new topology,
               and continue.
               PTG mapping functions are pure functions of the *current*
               shard count, so schedules regenerate in O(local tasks).

The decision logic is pure and unit-tested; the transport (who collects
heartbeats) is the same rank-0 pattern as the paper's completion protocol.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass
class HeartbeatMonitor:
    n_hosts: int
    dead_after: float = 60.0
    last_seen: Dict[int, float] = field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self.last_seen[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h in range(self.n_hosts)
                if now - self.last_seen.get(h, -1e30) > self.dead_after]


@dataclass
class StragglerDetector:
    straggler_factor: float = 1.5
    patience: int = 3
    window: int = 32
    _times: Dict[int, deque] = field(default_factory=lambda: defaultdict(
        lambda: deque(maxlen=32)))
    _strikes: Dict[int, int] = field(default_factory=lambda: defaultdict(int))

    def record(self, host: int, step_time: float) -> None:
        self._times[host].append(step_time)

    def _median_of_medians(self) -> float:
        meds = sorted(sorted(t)[len(t) // 2] for t in self._times.values()
                      if t)
        return meds[len(meds) // 2] if meds else 0.0

    def stragglers(self) -> List[int]:
        med = self._median_of_medians()
        if med <= 0:
            return []
        out = []
        for host, t in self._times.items():
            if t and t[-1] > self.straggler_factor * med:
                self._strikes[host] += 1
            else:
                self._strikes[host] = 0
            if self._strikes[host] >= self.patience:
                out.append(host)
        return out


@dataclass
class ElasticPlan:
    survivors: List[int]
    mesh_shape: tuple
    restore_step: Optional[int]


@dataclass
class ElasticController:
    """Live decision loop around a training step loop.

    Each step every alive host calls :meth:`beat`; the controller (rank 0
    in a real cluster) calls :meth:`poll` and gets an :class:`ElasticPlan`
    back exactly when the failed set grows — i.e. when the survivor set
    must re-mesh and restore. Hosts never heard from are not declared
    dead (same rule as the runtime's failure detector: a lease only arms
    once the host has proven alive), so a slow cold start is not a
    failure. Deaths are cumulative: once failed, a host stays failed for
    the life of the controller.
    """

    n_hosts: int
    chips_per_host: int
    model_axis: int
    dead_after: float = 60.0

    def __post_init__(self) -> None:
        self.monitor = HeartbeatMonitor(self.n_hosts, self.dead_after)
        self.stragglers = StragglerDetector()
        self.failed: List[int] = []
        self.plans: List[ElasticPlan] = []
        self._pending_admits: List[int] = []

    def admit(self, host: int) -> None:
        """Grow path: announce a new host (or re-admit a failed one). The
        lease arming rule applies unchanged — the admitted host joins the
        mesh only once it has proven alive, i.e. :meth:`poll` emits the
        grow plan at the host's first heartbeat, not at admission. Until
        then it is neither a survivor nor declarable dead (never-seen
        hosts are ignored by the failure detector)."""
        if host >= self.n_hosts:
            self.n_hosts = host + 1
            self.monitor.n_hosts = host + 1
        if host in set(self.failed):
            self.failed.remove(host)
        # a re-admitted host must re-arm its lease from scratch: a stale
        # heartbeat from before its death must not resurrect it
        self.monitor.last_seen.pop(host, None)
        if host not in self._pending_admits:
            self._pending_admits.append(host)

    def beat(self, host: int, step_time: Optional[float] = None,
             now: Optional[float] = None) -> None:
        self.monitor.beat(host, now)
        if step_time is not None:
            self.stragglers.record(host, step_time)

    def declare_failed(self, host: int, now: Optional[float] = None) -> None:
        """Out-of-band death declaration: an authoritative source (the
        runtime's completion-protocol DEATH broadcast) already knows the
        host is gone — don't wait out the lease. Expressed through the
        monitor (an infinitely stale heartbeat) so the next :meth:`poll`
        emits the shrink plan through the one normal path; the never-seen
        rule no longer protects the host because it is now "heard from"."""
        if host in set(self.failed):
            return
        self.monitor.beat(host, -1e30 if now is None else now)

    def alive(self) -> List[int]:
        return [h for h in range(self.n_hosts) if h not in set(self.failed)]

    def poll(self, latest_ckpt: Optional[int],
             now: Optional[float] = None) -> Optional[ElasticPlan]:
        newly = [h for h in self.monitor.dead_hosts(now)
                 if h in self.monitor.last_seen and h not in set(self.failed)]
        grown = [h for h in self._pending_admits
                 if h in self.monitor.last_seen]
        if not newly and not grown:
            return None
        self.failed.extend(newly)
        for h in grown:
            self._pending_admits.remove(h)
        # admitted hosts still waiting on their first heartbeat are not
        # survivors yet — the plan meshes only proven-alive capacity
        plan = plan_remesh(self.n_hosts,
                           list(self.failed) + self._pending_admits,
                           self.chips_per_host, self.model_axis, latest_ckpt)
        self.plans.append(plan)
        return plan


def plan_remesh(n_hosts: int, failed: Sequence[int], chips_per_host: int,
                model_axis: int, latest_ckpt: Optional[int]) -> ElasticPlan:
    """Largest (data × model) mesh that fits the survivor set, keeping the
    model axis fixed (TP width is a property of the arch config) and
    shrinking data parallelism — batch is re-divided by the data pipeline
    (deterministic in (seed, step), so no data is skipped or repeated)."""
    survivors = [h for h in range(n_hosts) if h not in set(failed)]
    chips = len(survivors) * chips_per_host
    if chips < model_axis:
        raise RuntimeError(
            f"survivor set too small: {chips} chips < model axis {model_axis}")
    data = chips // model_axis
    return ElasticPlan(survivors=survivors, mesh_shape=(data, model_axis),
                       restore_step=latest_ckpt)
