"""Sequential Task Flow (STF) baseline — the StarPU-style comparison point.

The paper's central comparison (§I-B, §III) is PTG vs STF: an STF runtime
discovers the DAG by *sequentially* enumerating tasks with data-access modes
(READ / WRITE / READWRITE) and inferring dependencies from last-writer /
reader sets. This file implements that model on top of the same
work-stealing threadpool, so benchmark deltas isolate the *DAG-discovery
strategy*, not the executor:

- task submission is single-threaded and builds the explicit DAG up front
  (the O(global DAG) cost the PTG avoids);
- every rank in a distributed STF run enumerates the *full* DAG (as StarPU's
  MPI mode does), while the PTG discovers only its local slice.

The port's copy of the JAX package's ``repro.core.stf``, equal in
behaviour.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Sequence

from .threadpool import Task, Threadpool

READ, WRITE, READWRITE = "R", "W", "RW"


@dataclass
class _Node:
    fn: Callable[[], None]
    indegree: int = 0
    indegree0: int = 0  # as submitted — execution consumes `indegree`
    out: List["_Node"] = field(default_factory=list)
    priority: float = 0.0
    mapping: int = 0


class STFGraph:
    """Sequential-semantics task submission with inferred dependencies."""

    def __init__(self, tp: Threadpool):
        self.tp = tp
        self._nodes: List[_Node] = []
        self._last_writer: Dict[Hashable, _Node] = {}
        self._readers_since_write: Dict[Hashable, List[_Node]] = {}
        self._lock = threading.Lock()
        self._remaining = 0
        self._executed = False

    def submit(
        self,
        fn: Callable[[], None],
        accesses: Sequence[tuple],  # (data_key, mode)
        *,
        priority: float = 0.0,
        mapping: int = 0,
    ) -> None:
        """Sequentially declare one task; dependencies are inferred (RAW,
        WAR, WAW hazards) from the access modes — StarPU's data model."""
        node = _Node(fn, priority=priority, mapping=mapping)
        deps: set = set()
        for key, mode in accesses:
            if mode in (READ, READWRITE):
                w = self._last_writer.get(key)
                if w is not None:
                    deps.add(id(w)); w.out.append(node)           # RAW
            if mode in (WRITE, READWRITE):
                for r in self._readers_since_write.get(key, []):
                    if r is not node:
                        deps.add(id(r)); r.out.append(node)       # WAR
                w = self._last_writer.get(key)
                if w is not None and id(w) not in deps:
                    deps.add(id(w)); w.out.append(node)           # WAW
                self._last_writer[key] = node
                self._readers_since_write[key] = []
            if mode in (READ, READWRITE):
                self._readers_since_write.setdefault(key, []).append(node)
        node.indegree = node.indegree0 = len(deps)
        self._nodes.append(node)

    def reset(self) -> None:
        """Restore every dependency counter to its submitted value so the
        same DAG can execute again. The edge structure is immutable —
        execution only consumes the counters — so resetting them is the
        whole job; this closes the one-shot dead end where the only answer
        to re-running a graph was rebuilding it from scratch."""
        if self._remaining:
            raise RuntimeError(
                "STFGraph.reset() while tasks are still in flight")
        for n in self._nodes:
            n.indegree = n.indegree0
        self._executed = False

    def execute(self) -> None:
        """Release roots, run the whole DAG, block until done.

        Execution consumes the per-node ``indegree`` counters, so calling
        this twice without a :meth:`reset` in between would see every node
        at zero and release the whole DAG at once, silently ignoring all
        dependencies — hence the guard.
        """
        if self._executed:
            raise RuntimeError(
                "STFGraph.execute() already ran; dependency counters are "
                "consumed and a re-run would ignore every edge. Call "
                "reset() (or build a fresh STFGraph) to run again.")
        self._executed = True
        self._remaining = len(self._nodes)
        done = threading.Event()
        lock = threading.Lock()

        def run_node(node: _Node) -> None:
            node.fn()
            for succ in node.out:
                with lock:
                    succ.indegree -= 1
                    ready = succ.indegree == 0
                if ready:
                    self.tp.insert(Task(run=lambda s=succ: run_node(s),
                                        priority=succ.priority), succ.mapping)
            with lock:
                self._remaining -= 1
                if self._remaining == 0:
                    done.set()

        roots = [n for n in self._nodes if n.indegree == 0]
        if not self._nodes:
            return
        for n in roots:
            self.tp.insert(Task(run=lambda s=n: run_node(s), priority=n.priority),
                           n.mapping)
        done.wait()
