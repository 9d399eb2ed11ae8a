"""Taskflow<K> — the Parametrized Task Graph of TaskTorrent (§II-A1b).

The DAG is *never stored*: the user provides pure functions over an index
space K —

- ``indegree(k)``  number of in-dependencies of task ``k``;
- ``task(k)``      the body; typically computes then ``fulfill_promise`` of
                   downstream tasks (locally) or sends an active message
                   (remotely);
- ``mapping(k)``   the worker thread ``k`` is initially mapped to;
- ``priority(k)``  optional max-heap priority (default 0);
- ``binding(k)``   optional: bind ``k`` to its thread (not stealable).

Dependency counters live in per-thread hash maps (sharded by ``mapping(k)``,
§II-B1): a counter for ``k`` is only ever touched by thread ``mapping(k)``.
``fulfill_promise(k)`` called from any other thread routes a bound
micro-task to the owner thread; called *on* the owner thread it decrements
in-place. The runtime therefore becomes aware of a task only when its first
dependency is fulfilled, and forgets it as soon as it is spawned — O(live
tasks) state, never O(DAG).

The port's copy of the JAX package's ``repro.core.taskflow``, equal in
behaviour.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Hashable, Optional, TypeVar

from .threadpool import Task, Threadpool, current_thread_id

K = TypeVar("K", bound=Hashable)


class Taskflow(Generic[K]):
    def __init__(self, threadpool: Threadpool, name: str = "tf"):
        self.tp = threadpool
        self.name = name
        self._indegree: Optional[Callable[[K], int]] = None
        self._task: Optional[Callable[[K], None]] = None
        self._mapping: Optional[Callable[[K], int]] = None
        self._priority: Callable[[K], float] = lambda k: 0.0
        self._binding: Callable[[K], bool] = lambda k: False
        # One dependency-counter map per worker thread (sharded, §II-B1).
        self._deps: list[Dict[K, int]] = [dict() for _ in range(threadpool.n_threads)]

    # ----------------------------------------------------------- PTG spec

    def set_indegree(self, fn: Callable[[K], int]) -> "Taskflow[K]":
        self._indegree = fn
        return self

    def set_task(self, fn: Callable[[K], None]) -> "Taskflow[K]":
        self._task = fn
        return self

    set_run = set_task  # paper uses set_run in the example listing

    def set_mapping(self, fn: Callable[[K], int]) -> "Taskflow[K]":
        self._mapping = fn
        return self

    def set_priority(self, fn: Callable[[K], float]) -> "Taskflow[K]":
        self._priority = fn
        return self

    def set_binding(self, fn: Callable[[K], bool]) -> "Taskflow[K]":
        self._binding = fn
        return self

    # ----------------------------------------------------------- execution

    def fulfill_promise(self, k: K) -> None:
        """Fulfill one in-dependency of task ``k`` (thread-safe)."""
        owner = self._mapping(k) % self.tp.n_threads
        if current_thread_id() == owner:
            self._decrement(owner, k)
        else:
            # Route a *bound* micro-task to the owner thread so the sharded
            # map is only ever touched by its owner (no data races).
            self.tp.insert(
                Task(run=lambda: self._decrement(owner, k), priority=float("inf"),
                     name=f"{self.name}:dec"),
                owner,
                bound=True,
            )

    def _decrement(self, owner: int, k: K) -> None:
        deps = self._deps[owner]
        count = deps.get(k)
        if count is None:
            count = self._indegree(k)
            if count < 1:
                raise ValueError(f"indegree({k!r}) = {count}; must be >= 1")
        count -= 1
        if count == 0:
            deps.pop(k, None)  # forget the task: O(live tasks) state
            self._spawn(owner, k)
        else:
            deps[k] = count

    def _spawn(self, owner: int, k: K) -> None:
        self.tp.insert(
            Task(run=lambda: self._task(k), priority=self._priority(k),
                 name=f"{self.name}:{k!r}"),
            owner,
            bound=self._binding(k),
        )

    # ------------------------------------------------------------- helpers

    def pending(self) -> int:
        """Number of partially-fulfilled (live) tasks — O(1) metadata check."""
        return sum(len(d) for d in self._deps)

    def snapshot(self) -> dict:
        """Live-task state for deadlock/timeout forensics: per-thread counts
        of partially-fulfilled tasks (the only state the runtime holds)."""
        per_thread = [len(d) for d in self._deps]
        return {"name": self.name, "live": sum(per_thread),
                "per_thread": per_thread}
