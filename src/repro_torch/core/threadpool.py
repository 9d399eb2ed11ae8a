"""Work-stealing threadpool — the shared-memory half of TaskTorrent.

Faithful to §II-B1 of the paper:

- each worker thread owns *two* priority queues of ready tasks — one for
  tasks *bound* to the thread and one for *stealable* tasks;
- the queues are lock-protected so any thread may insert into any queue;
- an idle worker first drains its own queues, then attempts to steal the
  highest-priority stealable task from another worker;
- ``join()`` returns once every worker is idle and (when a
  :class:`~repro_torch.core.messages.Communicator` is attached) the distributed
  completion protocol has established global quiescence.

The port's copy of the JAX package's ``repro.core.threadpool``, equal in
behaviour.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# Worker-thread identity, set once per worker; consumed by Taskflow to decide
# whether a dependency decrement may run in-place (owner thread) or must be
# routed. Correct under work stealing (identity is the *executing* thread).
_tls = threading.local()


def current_thread_id() -> Optional[int]:
    return getattr(_tls, "thread_id", None)


@dataclass(order=True)
class Task:
    """A ready-to-run task. Ordered by (-priority, seq): max-priority first."""

    sort_key: tuple = field(init=False, repr=False)
    run: Callable[[], Any] = field(compare=False)
    priority: float = field(default=0.0, compare=False)
    name: str = field(default="", compare=False)

    _seq = itertools.count()

    def __post_init__(self) -> None:
        # Negate priority: heapq is a min-heap, the paper uses max-priority.
        self.sort_key = (-self.priority, next(Task._seq))


class _WorkerQueues:
    """The two per-thread priority queues (bound + stealable) of §II-B1."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.bound: list[Task] = []
        self.stealable: list[Task] = []

    def push(self, task: Task, bound: bool) -> None:
        with self.lock:
            heapq.heappush(self.bound if bound else self.stealable, task)

    def pop_local(self) -> Optional[Task]:
        """Pop the highest-priority task across both queues (owner thread)."""
        with self.lock:
            pick_bound = bool(self.bound) and (
                not self.stealable or self.bound[0] < self.stealable[0]
            )
            if pick_bound:
                return heapq.heappop(self.bound)
            if self.stealable:
                return heapq.heappop(self.stealable)
            return None

    def steal(self) -> Optional[Task]:
        """Pop the highest-priority *stealable* task (foreign thread)."""
        with self.lock:
            if self.stealable:
                return heapq.heappop(self.stealable)
            return None


class Threadpool:
    """A fixed set of worker threads receiving and processing :class:`Task`s.

    Mirrors the paper's ``Threadpool tp(n_threads, &comm)``.  When ``comm`` is
    given, ``join()`` uses the distributed completion protocol (§II-B3) to
    decide termination; otherwise local quiescence (zero in-flight tasks)
    suffices.

    ``start=False`` reproduces the paper's micro-benchmark setup where task
    insertion happens before ``tp.start()`` so insertion time can be excluded
    from the measurement.
    """

    def __init__(self, n_threads: int, comm=None, *, start: bool = True):
        if n_threads < 1:
            raise ValueError("need at least one worker thread")
        self.n_threads = n_threads
        self.comm = comm
        self._queues = [_WorkerQueues() for _ in range(n_threads)]
        self._started = threading.Event()
        self._shutdown = threading.Event()
        # in-flight = queued-but-not-finished tasks; quiescent <=> 0.
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._tasks_run = 0
        self._steals = 0
        self._errors: list[BaseException] = []
        self._threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True)
            for i in range(n_threads)
        ]
        if comm is not None:
            comm.attach_threadpool(self)
        for t in self._threads:
            t.start()
        if start:
            self.start()

    # ------------------------------------------------------------------ API

    def start(self) -> None:
        self._started.set()

    def insert(self, task: Task, thread: int, *, bound: bool = False) -> None:
        """Insert a ready task into ``thread``'s queue (any thread may call)."""
        with self._inflight_lock:
            self._inflight += 1
        self._queues[thread % self.n_threads].push(task, bound)

    def join(self) -> None:
        """Block until quiescent (and, distributed, globally complete)."""
        self._started.set()
        if self.comm is not None:
            # Distributed: the communicator's progress loop runs the
            # completion protocol; it flips `_shutdown` on SHUTDOWN.
            self.comm.run_until_shutdown()
        else:
            while not self.quiescent():
                time.sleep(50e-6)
        self._shutdown.set()
        for t in self._threads:
            t.join()
        if self._errors:
            raise self._errors[0]

    def abort(self) -> None:
        """Hard-stop for a crashing rank (fault-plan kill or poisoned
        world): discard every queued task and release the workers. The
        in-flight accounting is deliberately left inconsistent — nobody
        joins an aborted pool."""
        self._shutdown.set()
        self._started.set()
        for q in self._queues:
            with q.lock:
                q.bound.clear()
                q.stealable.clear()

    def quiescent(self) -> bool:
        """True iff no task is queued or running on this rank."""
        with self._inflight_lock:
            return self._inflight == 0

    @property
    def stats(self) -> dict:
        return {"tasks_run": self._tasks_run, "steals": self._steals}

    # --------------------------------------------------------------- worker

    def _next_task(self, me: int) -> Optional[Task]:
        task = self._queues[me].pop_local()
        if task is not None:
            return task
        # Work stealing: scan other workers' stealable queues.
        for off in range(1, self.n_threads):
            task = self._queues[(me + off) % self.n_threads].steal()
            if task is not None:
                self._steals += 1
                return task
        return None

    def _worker(self, me: int) -> None:
        _tls.thread_id = me
        self._started.wait()
        idle_spins = 0
        while True:
            task = self._next_task(me)
            if task is None:
                if self._shutdown.is_set():
                    return
                idle_spins += 1
                # Exponential-ish backoff; keeps the GIL available.
                time.sleep(20e-6 if idle_spins < 100 else 200e-6)
                continue
            idle_spins = 0
            try:
                task.run()
            except BaseException as e:  # surfaced at join()
                self._errors.append(e)
            finally:
                self._tasks_run += 1
                with self._inflight_lock:
                    self._inflight -= 1
