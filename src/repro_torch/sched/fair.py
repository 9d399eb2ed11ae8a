"""Weighted fair scheduling across clients, on Taskflow's priority hook.

The port's copy of the JAX package's ``repro.sched.fair`` (pure Python).

The host runtime already has everything needed for a scheduling *policy*:
worker threads pop a max-priority heap, and ``Taskflow.set_priority`` is
evaluated exactly once per task — at spawn time, when its last dependency
lands and it enters the ready queue. Start-time fair queuing (SFQ) drops
straight into that hook:

- each client owns a *lane* with a virtual time; admitting a task charges
  the lane ``1/weight`` virtual seconds and the task's priority is the
  negated start tag, so the heap drains lanes in virtual-time order —
  weighted round-robin over whatever is concurrently ready;
- an idle lane resuming is clamped to the global virtual "now"
  (``max(lane, vnow)``): a client that sat out earns no unbounded credit
  and cannot starve the others when it returns;
- a submission-level ``priority`` is added as a bias on top of the start
  tag, so higher-priority work from the *same* client overtakes its
  lower-priority backlog (order across clients stays governed by the
  lanes — fairness first, priorities within).

The policy is per rank (each rank schedules its own ready queue), pure
arithmetic, and deterministic for a deterministic admission order — what
``tests/test_scheduler.py`` exploits to assert the WRR interleaving
exactly.
"""

from __future__ import annotations

import threading
from typing import Dict


class FairPolicy:
    """Start-time fair queuing: ``priority_for`` returns the max-heap
    priority for one task of ``client`` entering the ready queue."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._vnow = 0.0
        self._lanes: Dict[str, float] = {}

    def priority_for(self, client: str, weight: float = 1.0,
                     bias: float = 0.0) -> float:
        with self._lock:
            start = max(self._lanes.get(client, 0.0), self._vnow)
            self._lanes[client] = start + 1.0 / max(weight, 1e-9)
            self._vnow = start
            return bias - start

    def snapshot(self) -> dict:
        """Lane state for timeout forensics: which client's virtual time
        is ahead says who the rank has been serving."""
        with self._lock:
            return {"vnow": self._vnow, "lanes": dict(self._lanes)}
