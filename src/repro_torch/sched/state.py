"""Per-task state machine + live-frontier accounting for the scheduler.

The port's copy of the JAX package's ``repro.sched.state``: block values
are tensors on the service's device.

TaskTorrent's memory claim is O(live tasks), never O(DAG): the runtime
learns of a task at its first fulfilled dependency and forgets it when it
spawns. The stream scheduler extends the same discipline to *block state*
across many submissions: every block value (operand overlay, halo copy,
namespace version) is reference-counted and dropped the moment its last
consumer is done, so a service that has executed a million tasks holds
only the live frontier — what :class:`LiveStats` measures as the
high-water mark the ``live_frac`` benchmark guard tracks.

The task lifecycle is ``waiting -> ready -> running -> done -> retired``:

- *waiting* is implicit (the Taskflow only materializes a counter at the
  first fulfillment — tasks never touched have no state at all);
- *ready* is recorded at spawn time (the Taskflow's priority hook, which
  is evaluated exactly once per task, when its last dependency lands);
- *done* when the body has run and every out-edge is discharged;
- *retired* when all consumers of the task's write are themselves done —
  the task's record and its block refcounts are dropped.
"""

from __future__ import annotations

import enum
import threading
from typing import Dict, Hashable, List, Optional

K = Hashable
B = Hashable


class TaskState(enum.Enum):
    WAITING = "waiting"
    READY = "ready"
    RUNNING = "running"
    DONE = "done"
    RETIRED = "retired"


class LiveStats:
    """Lock-guarded live/total/high-water counters for one rank.

    ``blocks_*`` counts materialized block values (submission overlays,
    halo copies, namespace versions); ``tasks_*`` counts tasks between
    READY and RETIRED. ``live_frac`` — the benchmark guard — is
    ``blocks_hwm / blocks_total``: near 1.0 means retirement is broken and
    memory tracks total submitted work; small means it tracks the frontier.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.tasks_live = 0
        self.tasks_total = 0
        self.tasks_hwm = 0
        self.blocks_live = 0
        self.blocks_total = 0
        self.blocks_hwm = 0

    def task_up(self, n: int = 1) -> None:
        with self._lock:
            self.tasks_live += n
            self.tasks_total += n
            self.tasks_hwm = max(self.tasks_hwm, self.tasks_live)

    def task_down(self, n: int = 1) -> None:
        with self._lock:
            self.tasks_live -= n

    def block_up(self, n: int = 1) -> None:
        with self._lock:
            self.blocks_live += n
            self.blocks_total += n
            self.blocks_hwm = max(self.blocks_hwm, self.blocks_live)

    def block_down(self, n: int = 1) -> None:
        with self._lock:
            self.blocks_live -= n

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "tasks_live": self.tasks_live,
                "tasks_total": self.tasks_total,
                "tasks_hwm": self.tasks_hwm,
                "blocks_live": self.blocks_live,
                "blocks_total": self.blocks_total,
                "blocks_hwm": self.blocks_hwm,
            }


class SubmissionShard:
    """One rank's slice of one in-flight submission.

    Holds the lazily derived :class:`~repro_torch.ptg.graph.LocalView`, the
    per-submission Taskflow, the block overlay (owned writes + halo copies
    + namespace-bound external inputs), and the reference counts that
    drive retirement:

    - ``consumers_left[k]``: out-edges of owned task ``k`` not yet
      discharged (a local consumer discharges at completion; a remote one
      the moment its fulfillment is handed to the reliable transport) —
      at zero a DONE task retires and its record is dropped;
    - ``readers_left[blk]``: owned tasks that will still read ``blk`` —
      at zero the overlay value is freed.

    All mutation is under ``lock``; the scan that builds the counts is
    O(owned edges) — exactly the state the view already materialized.
    """

    def __init__(self, sub, view, tf, stats: LiveStats,
                 shard: Optional[int] = None) -> None:
        self.sub = sub
        self.view = view
        self.tf = tf
        self.stats = stats
        # the logical shard this slice represents — equal to the hosting
        # rank until a death moves it to an adopter (service routes by it)
        self.shard = view.shard if shard is None else shard
        self.lock = threading.Lock()
        # cross-shard fulfillments applied, keyed (consumer, producer):
        # transport retransmits are deduped by seq, but recovery re-execution
        # and send-log replay legitimately re-produce the same fulfillment —
        # each promise must still be decremented exactly once
        self.applied: set = set()
        # initial-value seeds this shard's owner actually honored (reported
        # to the frontdoor checkpoint at completion, for adoption replay)
        self.seeded: Dict[B, object] = {}
        self.store: Dict[B, object] = {}
        self.state: Dict[K, TaskState] = {}   # absent == WAITING or RETIRED
        self.retired = 0
        self.remaining = len(view.tasks)
        self.failed = False
        self.published: Dict[B, object] = {}  # this rank's final writes
        self.fetch_waiters: Dict[B, List[K]] = {}
        self.consumers_left: Dict[K, int] = {
            k: len(view.out_deps(k)) for k in view.tasks}
        readers: Dict[B, int] = {}
        for k in view.tasks:
            for blk in set(view.operands(k)):
                readers[blk] = readers.get(blk, 0) + 1
        self.readers_left = readers

    # ------------------------------------------------------- state machine

    def mark_ready(self, k: K) -> None:
        with self.lock:
            self.state[k] = TaskState.READY
        self.stats.task_up()

    def mark_running(self, k: K) -> None:
        with self.lock:
            self.state[k] = TaskState.RUNNING

    def put(self, blk: B, value) -> None:
        """Store a block value, counting only first materialization."""
        with self.lock:
            fresh = blk not in self.store
            self.store[blk] = value
        if fresh:
            self.stats.block_up()

    def complete(self, k: K, n_remote_consumers: int) -> bool:
        """Record owned task ``k`` DONE, discharge its remote out-edges,
        retire whatever became retirable, and free dead block values.
        Returns True when this was the shard's last owned task."""
        view = self.view
        freed = 0
        retired = 0
        with self.lock:
            self.state[k] = TaskState.DONE
            self.consumers_left[k] -= n_remote_consumers
            retired += self._maybe_retire(k)
            for p in view.in_deps(k):
                if p in self.consumers_left:       # local producer
                    self.consumers_left[p] -= 1
                    retired += self._maybe_retire(p)
            blk_w = view.block_of(k)
            for blk in set(view.operands(k)):
                self.readers_left[blk] -= 1
                if self.readers_left[blk] == 0 and blk in self.store:
                    del self.store[blk]
                    freed += 1
            # a write nobody here reads (payloads/publication already
            # captured the value) is dead the moment it lands
            if self.readers_left.get(blk_w, 0) == 0 and blk_w in self.store:
                del self.store[blk_w]
                freed += 1
            self.remaining -= 1
            last = self.remaining == 0
        if freed:
            self.stats.block_down(freed)
        if retired:
            self.stats.task_down(retired)
        return last

    def _maybe_retire(self, k: K) -> int:
        """(Caller holds ``lock``.) Retire ``k`` if DONE with no undischarged
        consumers: drop its record — the O(live) forgetting step."""
        if (self.consumers_left.get(k) == 0
                and self.state.get(k) is TaskState.DONE):
            del self.consumers_left[k]
            del self.state[k]
            self.retired += 1
            return 1
        return 0

    def drop(self) -> None:
        """Release whatever overlay state is left (submission finished
        locally, or failed — partial state must not outlive it)."""
        with self.lock:
            n = len(self.store)
            self.store.clear()
            live = len(self.state)
            self.state.clear()
        if n:
            self.stats.block_down(n)
        if live:
            self.stats.task_down(live)
