"""Declarative PTG builder — one graph definition, two lowerings.

TaskTorrent's headline API is a *single* parametrized task graph
(``set_indegree`` / ``set_task`` / ``set_mapping``, §II-A) from which the
distributed DAG is discovered in parallel. Hand-writing that PTG for the
compiled layer means supplying ``in_deps`` AND ``out_deps`` and keeping
them mutual inverses by eye — get one edge wrong and the payload it should
carry is silently never sent. This module derives both sides from what an
application can state declaratively (the Specx/StarPU data-access model,
arXiv 2308.15964):

- **task types** over typed index spaces (``task_type(name, space=...)``);
- per task, the block it ``writes`` and the blocks it ``reads`` (ordered —
  this is the compute body's operand list), plus optional ``after`` edges
  for pure control sequencing (staged send chains, serial resources);
- a ``Graph``-level ``owner`` mapping blocks to shards ("owner computes":
  a task runs on the shard owning the block it writes).

Dependency derivation runs the classic sequential-semantics access scan
(RAW / WAR / WAW hazards over the program order), recording every edge
**from both ends at once** — so ``in_deps`` and ``out_deps`` are mutual
inverses *by construction*, and ``indegree``, ``operands``, ``block_of``,
and the seed set all fall out of the same declarations. The derived edge
functions reproduce the hand-written specs of every app in this repo
exactly (task-for-task, edge-for-edge, order-for-order; the port's
``tests/test_torch_ptg.py`` holds every derivation against the JAX
package's).

Derivation comes in two flavors:

- **lazy per-shard** (:meth:`Graph.derive_local`, the default lowering
  path): each shard derives edges only for its *owned tasks + halo* — the
  frontier one ``reads``/``writes`` overlap away — so no rank ever
  materializes the global edge dicts, matching the paper's claim that the
  DAG is "completely distributed and discovered in parallel";
- **eager global** (:meth:`Graph.build`): the full scan over the whole
  index space, kept as the statically queryable form and as the validation
  oracle the lazy path is proven edge-for-edge identical to
  (``tests/test_torch_ptg.py``).

A ``Graph`` lowers to the block executor: ``to_block_spec()`` /
``to_program()`` give a :class:`~repro_torch.core.schedule.BlockPTGSpec` /
:class:`~repro_torch.core.schedule.BlockProgram`, fed through parallel
discovery and the classified comm-plan lowering. It also lowers to the
host TaskTorrent runtime: ``to_taskflow()`` wires one rank's Taskflow and
``run_host()`` runs every rank, with block stores on a device.

For *unbounded* index spaces (where enumeration is impossible) write the
``PTG`` directly with a user-supplied inverse rule and validate it with
:func:`checked_ptg` / :meth:`PTG.check_consistency` — the sampled form of
the same guarantee.
"""

from __future__ import annotations

from typing import (Callable, Dict, Hashable, Iterable, List, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.core.discovery import (PTG, WavefrontSchedule, discover,
                                        discover_local, union_ptg)

K = Hashable  # task key (as the app knows it, e.g. ("gemm", i, k, j))
B = Hashable  # block id


class LocalView:
    """One shard's lazily derived slice of a :class:`Graph`'s PTG.

    Produced by :meth:`Graph.derive_local`: edge dicts exist **only** for
    the tasks this shard owns; remote tasks appear solely as keys inside
    those edge lists (plus their ``mapping``, so discovery can route
    fulfillments without asking any other shard). Invariant, asserted by
    ``tests/test_torch_ptg.py``: for every owned task the stored
    ``in_deps`` / ``out_deps`` / ``operands`` / ``block_of`` / ``type_of``
    / ``mapping`` are value- and order-identical to what the eager
    :meth:`Graph.build` derives for that task.

    ``stats`` quantifies the laziness: ``n_owned`` / ``n_halo`` scanned
    tasks, ``derived_edges`` (edge-list entries stored — the peak, since
    derivation only appends),
    ``n_relevant_blocks`` (blocks whose access state was tracked),
    ``n_tasks_global`` (index-space size, for the ratio columns), and
    ``pass1_scanned`` (tasks whose access functions pass 1 evaluated:
    the whole space for an opaque callable, only the shard's strip for a
    partitionable :class:`IndexSpace`).
    """

    def __init__(self, graph_name: str, shard: int, n_shards: int):
        self.graph_name = graph_name
        self.shard = shard
        self.n_shards = n_shards
        self.tasks: List[K] = []     # owned tasks, program order
        self.seeds: List[K] = []     # owned zero-indegree tasks, program order
        self.pos: Dict[K, int] = {}  # owned task -> global program position
        self.stats: Dict[str, int] = {}
        self._in: Dict[K, List[K]] = {}
        self._out: Dict[K, List[K]] = {}
        self._operands: Dict[K, List[B]] = {}
        self._block: Dict[K, B] = {}
        self._type: Dict[K, str] = {}
        self._map: Dict[K, int] = {}  # owned AND halo tasks
        self._ext: Dict[K, List[B]] = {}     # owned -> external-read blocks
        self._payload: Dict[K, set] = {}     # owned -> consumers reading it
        # relevant block -> its last writer in program order (owned or halo)
        self.final_writes: Dict[B, K] = {}

    def _get(self, table: Dict[K, object], k: K, what: str):
        try:
            return table[k]
        except KeyError:
            raise KeyError(
                f"task {k!r}: no {what} on shard {self.shard} of graph "
                f"{self.graph_name!r} (not an owned task of this view)")

    def in_deps(self, k: K) -> Sequence[K]:
        """Dependencies of owned task ``k`` (same order as the eager scan:
        RAW in operand order, WAR, WAW, then ``after`` control edges)."""
        return self._get(self._in, k, "in_deps")

    def out_deps(self, k: K) -> Sequence[K]:
        """Consumers owned task ``k`` fulfills (data consumers in program
        order, then control consumers) — may include remote tasks."""
        return self._get(self._out, k, "out_deps")

    def operands(self, k: K) -> Sequence[B]:
        """Blocks owned task ``k`` reads, in compute-body operand order."""
        return self._get(self._operands, k, "operands")

    def block_of(self, k: K) -> B:
        """The single block owned task ``k`` writes."""
        return self._get(self._block, k, "block_of")

    def type_of(self, k: K) -> str:
        """Task-type name of owned task ``k``."""
        return self._get(self._type, k, "type_of")

    def mapping(self, k: K) -> int:
        """Shard of ``k`` — defined for owned tasks *and* the halo tasks
        appearing in this view's edge lists (out-edge routing needs it)."""
        return self._get(self._map, k, "mapping")

    def external_reads(self, k: K) -> Sequence[B]:
        """Distinct operand blocks of owned task ``k`` with no producer
        inside this graph — the reads a one-shot execution satisfies from
        the initial store, and a stream scheduler from a block namespace
        (the previous submission's final writes)."""
        return self._get(self._ext, k, "external_reads")

    def payload_consumers(self, k: K):
        """Consumers of owned task ``k`` that *read* the block it writes —
        exactly the out-edges whose active message must carry the produced
        value (WAR/WAW/control edges carry none). Derived during the local
        scan, so a rank needs no global spec to route payloads."""
        return self._payload.get(k, frozenset())

    def __repr__(self) -> str:
        return (f"LocalView({self.graph_name!r}, shard={self.shard}, "
                f"{len(self.tasks)} owned, "
                f"{self.stats.get('n_halo', 0)} halo, "
                f"{self.stats.get('derived_edges', 0)} edges)")


class IndexSpace:
    """A typed, *partitionable* index space (or program sequence).

    A plain callable space is opaque: :meth:`Graph.derive_local`'s pass 1
    must evaluate every task's accesses across the whole program to find the
    shard's strip — an O(global) term on every rank. An ``IndexSpace``
    additionally knows its own structure (a grid, a triangular Cholesky
    space, a width×depth task grid), so each shard enumerates **only its
    strip** and pass 1 becomes O(owned).

    - ``enum()``           — full enumeration, in this space's program
      order (exactly what the plain callable did);
    - ``owned(shard)``     — only the entries whose *task* lands on
      ``shard`` under the graph's declared owner/mapping. Membership must
      be exact (derive_local cross-checks each yielded task's shard and
      raises on a stray); order is free — pass 1 only builds sets;
    - ``size``             — optional total entry count (stats only).

    Used either as a per-type ``space=`` (entries are index tuples) or as
    the ``Graph.sequence`` program (entries are ``(type_name, *index)``).
    ``enumerate_owned`` returns ``None`` when it cannot partition — e.g.
    under an ``owner_map`` override rebalancing blocks arbitrarily — and
    derivation falls back to the full scan (opaque-space behavior)."""

    def __init__(self, enum: Callable[[], Iterable],
                 owned: Callable[[int], Iterable],
                 size: Optional[int] = None):
        self._enum = enum
        self._owned = owned
        self._size = size

    def __call__(self) -> Iterable:
        return self._enum()

    def enumerate_owned(self, shard: int,
                        owner_map: Optional[Callable] = None
                        ) -> Optional[Iterable]:
        """Entries of ``shard``'s strip, or ``None`` when this space cannot
        partition under ``owner_map`` (strips are derived from the graph's
        *declared* owner; an override invalidates them)."""
        if owner_map is not None:
            return None
        return self._owned(shard)

    def __len__(self) -> int:
        if self._size is None:
            raise TypeError("IndexSpace declared without a size")
        return self._size


class TaskType:
    """One task family: an index space plus block-access declarations.

    ``writes(*idx)`` — the single block the task writes (owner computes);
    ``reads(*idx)``  — blocks read, in the compute body's operand order
                       (include the written block to read-modify-write it);
    ``after(*idx)``  — keys of *earlier* tasks to sequence behind (control
                       edges that carry no data: staged send chains, serial
                       resources);
    ``space()``      — index-tuple enumerator; its order is the sequential
                       program order unless the Graph supplies an
                       interleaved ``sequence``;
    ``key(*idx)``    — task-key override (default ``(name, *idx)``) so
                       existing key shapes survive the migration;
    ``mapping(*idx)``— shard override (default: owner of the written block).
    """

    def __init__(self, name: str, *,
                 writes: Callable[..., B],
                 reads: Optional[Callable[..., Sequence[B]]] = None,
                 after: Optional[Callable[..., Sequence[K]]] = None,
                 space: Optional[Callable[[], Iterable]] = None,
                 key: Optional[Callable[..., K]] = None,
                 mapping: Optional[Callable[..., int]] = None):
        self.name = name
        self.writes = writes
        self.reads = reads
        self.after = after
        self.space = space
        self.key = key
        self.mapping = mapping

    def key_of(self, idx: Tuple) -> K:
        return self.key(*idx) if self.key is not None else (self.name, *idx)


class Graph:
    """Declarative PTG: register task types, then lower to either back-end.

    Lowerings (:meth:`to_block_spec` / :meth:`to_schedule` /
    :meth:`to_program` / :meth:`executor`) derive the graph **lazily per
    shard** by default (:meth:`derive_local`: owned tasks + halo only —
    the global edge dicts are never materialized). Static queries
    (``tasks``, ``seeds``, ``in_deps(k)``, ...) trigger the eager global
    :meth:`build` instead; after it the derived ``in_deps`` / ``out_deps``
    / ``operands`` / ``block_of`` / ``mapping`` / ``type_of`` behave as
    the pure functions the ``PTG`` contract expects, and ``seeds`` holds
    the zero-indegree tasks in program order. Invariant: both derivations
    agree edge-for-edge (``tests/test_torch_ptg.py``).
    """

    def __init__(self, name: str, *, n_shards: int,
                 owner: Callable[[B], int],
                 block_shape: Tuple[int, int] = (1, 1),
                 dtype=torch.float32):
        self.name = name
        self.n_shards = n_shards
        self.owner = owner
        self.block_shape = block_shape
        self.dtype = dtype
        self._types: Dict[str, TaskType] = {}
        self._sequence: Optional[Callable[[], Iterable[Tuple]]] = None
        self._built = False
        self._derived = False  # any derive_local ran -> declarations frozen
        self._views: Optional[List[LocalView]] = None  # default-owner cache

    # ------------------------------------------------------- declaration

    def task_type(self, name: str, **kwargs) -> TaskType:
        """Register a task family (see :class:`TaskType` for the fields)."""
        self._check_mutable()
        if name in self._types:
            raise ValueError(f"task type {name!r} already registered")
        t = TaskType(name, **kwargs)
        self._types[name] = t
        return t

    def sequence(self, program: Callable[[], Iterable[Tuple]]) -> None:
        """Supply the sequential program order explicitly: a callable
        yielding ``(type_name, *index)`` tuples. Needed whenever types must
        interleave for sequential semantics (Cholesky's per-panel potrf /
        trsm / update rounds, Task-Bench's layer order); without it, types
        enumerate whole in registration order."""
        self._check_mutable()
        self._sequence = program

    def _check_mutable(self) -> None:
        """Declarations freeze at the first derivation — eager build OR any
        lazy per-shard derive — so no lowering can ever see stale edges
        (the lazy view cache would otherwise silently drop later
        declarations)."""
        if self._built:
            raise RuntimeError(f"graph {self.name!r} is already built")
        if self._derived:
            raise RuntimeError(
                f"graph {self.name!r} is already derived (a lowering or "
                "derive_local ran); declare every task type first")

    def _program_iter(self) -> Iterable[Tuple[TaskType, Tuple]]:
        if self._sequence is not None:
            for entry in self._sequence():
                tname = entry[0]
                if tname not in self._types:
                    raise ValueError(
                        f"sequence yielded unknown task type {tname!r}")
                yield self._types[tname], tuple(entry[1:])
            return
        for t in self._types.values():
            if t.space is None:
                raise ValueError(
                    f"task type {t.name!r} has no index space and the graph "
                    "has no sequence(); one of the two must enumerate it")
            for idx in t.space():
                yield t, idx if isinstance(idx, tuple) else (idx,)

    # -------------------------------------------------------- derivation

    def build(self) -> "Graph":
        """Derive the full edge structure (idempotent).

        Sequential-semantics access scan, exactly the STF inference
        (sequential task flow) but producing a *keyed, statically queryable*
        PTG instead of an eagerly-scheduled DAG: for each task in program
        order, RAW edges from the last writer of each read block, then
        WAR/WAW edges guarding the written block, then declared ``after``
        control edges. Each edge is recorded in the producer's out-list and
        the consumer's in-list in the same step — mutual inverse by
        construction.
        """
        if self._built:
            return self
        self._in: Dict[K, List[K]] = {}
        self._operands: Dict[K, List[B]] = {}
        self._block: Dict[K, B] = {}
        self._type: Dict[K, str] = {}
        self._map: Dict[K, int] = {}
        self._tasks: List[K] = []

        last_writer: Dict[B, K] = {}
        readers: Dict[B, List[K]] = {}          # readers since last write
        out_data: Dict[K, List[K]] = {}
        out_after: Dict[K, List[K]] = {}

        for t, idx in self._program_iter():
            k = t.key_of(idx)
            if k in self._in:
                raise ValueError(f"duplicate task key {k!r}")
            blk_w = t.writes(*idx)
            rds = list(t.reads(*idx)) if t.reads is not None else []

            deps: List[K] = []
            seen = {k}                           # never self-depend
            def _add(d):
                if d is not None and d not in seen:
                    seen.add(d)
                    deps.append(d)
            for blk in rds:                      # RAW, in operand order
                _add(last_writer.get(blk))
            for r in readers.get(blk_w, ()):     # WAR
                _add(r)
            _add(last_writer.get(blk_w))         # WAW
            for d in deps:
                out_data.setdefault(d, []).append(k)

            if t.after is not None:
                for d in t.after(*idx):
                    if d not in self._in:
                        raise ValueError(
                            f"task {k!r}: after-edge {d!r} does not name an "
                            "earlier task (sequential semantics require "
                            "control edges to point backwards)")
                    if d not in seen:
                        seen.add(d)
                        deps.append(d)
                        out_after.setdefault(d, []).append(k)

            self._in[k] = deps
            self._operands[k] = rds
            self._block[k] = blk_w
            self._type[k] = t.name
            self._map[k] = (t.mapping(*idx) if t.mapping is not None
                            else self.owner(blk_w))
            self._tasks.append(k)

            last_writer[blk_w] = k
            readers[blk_w] = [k] if blk_w in rds else []
            for blk in rds:
                if blk != blk_w:
                    readers.setdefault(blk, []).append(k)

        # data consumers first (in program order), then control consumers —
        # matching the convention of the hand-written specs this replaces.
        self._out: Dict[K, List[K]] = {
            k: out_data.get(k, []) + out_after.get(k, [])
            for k in self._tasks}
        self._seeds: List[K] = [k for k in self._tasks if not self._in[k]]
        self._built = True
        return self

    def _owned_program_iter(self, shard: int,
                            owner_map: Optional[Callable[[B], int]]
                            ) -> Optional[Iterable[Tuple[TaskType, Tuple]]]:
        """Strip enumeration for :meth:`derive_local`'s pass 1: yield only
        ``shard``'s owned ``(type, index)`` pairs, via the
        :class:`IndexSpace` protocol. Returns ``None`` — meaning *fall back
        to the full scan* — unless every space (or the sequence) is
        partitionable under ``owner_map``."""
        if self._sequence is not None:
            own = getattr(self._sequence, "enumerate_owned", None)
            if own is None:
                return None
            entries = own(shard, owner_map)
            if entries is None:
                return None

            def gen():
                for entry in entries:
                    tname = entry[0]
                    if tname not in self._types:
                        raise ValueError(
                            f"owned strip yielded unknown task type {tname!r}")
                    yield self._types[tname], tuple(entry[1:])
            return gen()
        strips = []
        for t in self._types.values():
            own = getattr(t.space, "enumerate_owned", None)
            if own is None:
                return None
            entries = own(shard, owner_map)
            if entries is None:
                return None
            strips.append((t, entries))

        def gen():
            for t, entries in strips:
                for idx in entries:
                    yield t, idx if isinstance(idx, tuple) else (idx,)
        return gen()

    # ------------------------------------------- lazy per-shard derivation

    def derive_local(self, shard: int,
                     owner_map: Optional[Callable[[B], int]] = None
                     ) -> LocalView:
        """Derive ``shard``'s slice of the PTG without building the global
        graph: the same sequential-semantics access scan as :meth:`build`,
        but with per-block state (last writer, readers-since-write) and
        edge lists materialized **only** for the shard's owned tasks plus
        their halo — the frontier reachable through one ``reads``/``writes``
        overlap. Peak derived state is O(owned + halo), never O(global
        edges); this is the paper's "the DAG is discovered piece by piece,
        in parallel" applied to derivation itself.

        ``owner_map`` overrides the graph's ``owner`` for this derivation
        (e.g. a rebalanced or ragged block distribution); tasks without an
        explicit ``TaskType.mapping`` follow it. Returns a
        :class:`LocalView`; feed one view per shard to
        :func:`repro_torch.core.discovery.discover_local` (what
        :meth:`to_schedule` / :meth:`to_block_spec` do by default).

        Why two passes: the halo block set (blocks owned tasks read) must
        be known *before* the scan — a halo block's last writer may precede
        the owned reader in program order, and a single pass would have
        skipped it. Pass 1 therefore fixes the owned-task and relevant-block
        sets; pass 2 runs the restricted scan. Correctness of the
        restriction: every edge incident to an owned task flows through a
        block that is relevant here (the task's written block, a block it
        reads, or an owned block a remote task touches), and no owned task
        ever touches an irrelevant block — so the per-block state
        trajectories, and hence the derived edges, match the global scan
        exactly.

        Pass 1's cost depends on the space: an opaque callable space forces
        the full O(global) relevance filter (evaluate every task's
        ``writes`` to test ownership), but a partitionable
        :class:`IndexSpace` lets the shard enumerate **only its strip** —
        O(owned) — and the filter disappears (``stats["pass1_scanned"]``
        records which happened). A strip entry mapping to the wrong shard
        raises immediately: a silently wrong strip would drop edges.
        """
        owner = owner_map if owner_map is not None else self.owner
        n = self.n_shards
        self._derived = True  # freeze declarations (see _check_mutable)

        # ---- pass 1: owned task keys + the halo/override block set
        owned_keys: set = set()
        extra_blocks: set = set()   # halo blocks + override-written blocks
        n_global = 0
        pass1_scanned = 0
        strip = self._owned_program_iter(shard, owner_map)
        if strip is not None:
            for t, idx in strip:
                pass1_scanned += 1
                blk_w = t.writes(*idx)
                t_shard = (t.mapping(*idx) if t.mapping is not None
                           else owner(blk_w)) % n
                if t_shard != shard:
                    raise ValueError(
                        f"index-space strip for shard {shard} yielded task "
                        f"{t.key_of(idx)!r} mapped to shard {t_shard} — the "
                        "space's enumerate_owned disagrees with the owner "
                        "mapping")
                owned_keys.add(t.key_of(idx))
                extra_blocks.add(blk_w)
                if t.reads is not None:
                    extra_blocks.update(t.reads(*idx))
        else:
            for t, idx in self._program_iter():
                n_global += 1
                pass1_scanned += 1
                blk_w = t.writes(*idx)
                t_shard = (t.mapping(*idx) if t.mapping is not None
                           else owner(blk_w)) % n
                if t_shard != shard:
                    continue
                owned_keys.add(t.key_of(idx))
                extra_blocks.add(blk_w)  # covers mapping-override ownership
                if t.reads is not None:
                    extra_blocks.update(t.reads(*idx))

        def rel(blk: B) -> bool:
            return blk in extra_blocks or owner(blk) % n == shard

        # ---- pass 2: restricted access scan (mirrors build() exactly on
        # the relevant-block subspace)
        view = LocalView(self.name, shard, n)
        last_writer: Dict[B, K] = {}
        readers: Dict[B, List[K]] = {}
        out_data: Dict[K, List[K]] = {}
        out_after: Dict[K, List[K]] = {}
        scanned: set = set()
        derived_edges = 0

        n_pass2 = 0
        for pos, (t, idx) in enumerate(self._program_iter()):
            n_pass2 += 1
            k = t.key_of(idx)
            owned = k in owned_keys
            blk_w = t.writes(*idx)
            rds = list(t.reads(*idx)) if t.reads is not None else []
            afters = (list(t.after(*idx)) if t.after is not None else [])
            if not owned and not (
                    rel(blk_w) or any(rel(b) for b in rds)
                    or any(d in owned_keys for d in afters)):
                continue
            if k in scanned:
                raise ValueError(f"duplicate task key {k!r}")
            scanned.add(k)

            deps: List[K] = []
            seen = {k}                           # never self-depend

            def _add(d):
                if d is not None and d not in seen:
                    seen.add(d)
                    deps.append(d)
            ext: List[B] = []
            for blk in rds:                      # RAW, in operand order
                p = last_writer.get(blk)
                _add(p)
                if p is not None and p in owned_keys:
                    # k reads p's written block: the p->k AM carries it
                    view._payload.setdefault(p, set()).add(k)
                elif p is None and owned and blk not in ext:
                    # no producer in this graph: an external input (every
                    # writer of a relevant block is scanned, so a missing
                    # last_writer here is global, not a restriction artifact)
                    ext.append(blk)
            for r in readers.get(blk_w, ()):     # WAR
                _add(r)
            _add(last_writer.get(blk_w))         # WAW
            for d in deps:
                if d in owned_keys:
                    out_data.setdefault(d, []).append(k)

            for d in afters:
                if d in owned_keys and d not in scanned:
                    raise ValueError(
                        f"task {k!r}: after-edge {d!r} does not name an "
                        "earlier task (sequential semantics require "
                        "control edges to point backwards)")
                if d not in seen:
                    seen.add(d)
                    deps.append(d)
                    if d in owned_keys:
                        out_after.setdefault(d, []).append(k)

            t_shard = (t.mapping(*idx) if t.mapping is not None
                       else owner(blk_w))
            view._map[k] = t_shard               # owned AND halo routing
            if owned:
                view._in[k] = deps
                derived_edges += len(deps)
                view._operands[k] = rds
                view._block[k] = blk_w
                view._type[k] = t.name
                view._ext[k] = ext
                view.pos[k] = pos
                view.tasks.append(k)

            if rel(blk_w):
                last_writer[blk_w] = k
                readers[blk_w] = [k] if blk_w in rds else []
            for blk in rds:
                if blk != blk_w and rel(blk):
                    readers.setdefault(blk, []).append(k)

        # data consumers first (program order), then control consumers —
        # the same convention as build()
        for k in view.tasks:
            out = out_data.get(k, []) + out_after.get(k, [])
            view._out[k] = out
            derived_edges += len(out)
        view.seeds = [k for k in view.tasks if not view._in[k]]
        # end-of-scan writer state: for every relevant block, the task whose
        # write survives the whole program — sound because every task that
        # touches a relevant block is scanned. The stream scheduler publishes
        # exactly these values into the submission's block namespace.
        view.final_writes = dict(last_writer)
        view.stats = {
            "n_owned": len(view.tasks),
            "n_halo": len(scanned) - len(view.tasks),
            "n_tasks_global": n_global or n_pass2,
            "derived_edges": derived_edges,
            "n_relevant_blocks": len(set(last_writer) | set(readers)),
            # tasks whose access functions pass 1 actually evaluated:
            # == n_tasks_global for an opaque space (the O(global)
            # relevance filter), == n_owned-ish for a partitionable
            # IndexSpace strip — the ratio discovery_scaling tracks.
            "pass1_scanned": pass1_scanned,
        }
        return view

    def local_views(self, owner_map: Optional[Callable[[B], int]] = None
                    ) -> List[LocalView]:
        """One :class:`LocalView` per shard (:meth:`derive_local` for every
        shard; the default-owner result is cached). On a real distributed
        system each rank would derive only its own view — deriving all of
        them here is the single-host emulation of that, and the per-view
        ``stats`` are what the distributed ranks would each pay."""
        if owner_map is not None:
            return [self.derive_local(s, owner_map)
                    for s in range(self.n_shards)]
        if self._views is None:
            self._views = [self.derive_local(s)
                           for s in range(self.n_shards)]
        return self._views

    # ---------------------------------------------------- derived queries

    def _get(self, table: str, k: K):
        self.build()
        try:
            return getattr(self, table)[k]
        except KeyError:
            raise KeyError(f"unknown task {k!r} in graph {self.name!r}")

    def in_deps(self, k: K) -> Sequence[K]:
        """Tasks ``k`` depends on — RAW in operand order, then WAR, WAW,
        and ``after`` control edges (mutual inverse of :meth:`out_deps`)."""
        return self._get("_in", k)

    def out_deps(self, k: K) -> Sequence[K]:
        """Tasks whose promises ``k`` fulfills — data consumers in program
        order, then control consumers (mutual inverse of :meth:`in_deps`)."""
        return self._get("_out", k)

    def operands(self, k: K) -> Sequence[B]:
        """Blocks ``k`` reads, in the compute body's operand order."""
        return self._get("_operands", k)

    def block_of(self, k: K) -> B:
        """The single block ``k`` writes ("owner computes" anchor)."""
        return self._get("_block", k)

    def type_of(self, k: K) -> str:
        """Name of the :class:`TaskType` that declared ``k``."""
        return self._get("_type", k)

    def mapping(self, k: K) -> int:
        """Shard ``k`` runs on: its ``TaskType.mapping`` override, else the
        owner of the block it writes."""
        return self._get("_map", k)

    def indegree(self, k: K) -> int:
        """``len(in_deps(k))`` — the promise count the runtime counts down."""
        return len(self._get("_in", k))

    @property
    def tasks(self) -> List[K]:
        """All task keys in sequential program order."""
        self.build()
        return self._tasks

    @property
    def seeds(self) -> List[K]:
        """Zero-indegree tasks in program order — the discovery roots."""
        self.build()
        return self._seeds

    @property
    def n_tasks(self) -> int:
        self.build()
        return len(self.tasks)

    # ---------------------------------------------------------- lowerings

    def to_ptg(self) -> PTG:
        """The statically queryable PTG (consistent by construction)."""
        self.build()
        return PTG(in_deps=self.in_deps, out_deps=self.out_deps,
                   mapping=self.mapping, type_of=self.type_of)

    def to_block_spec(self, *, block_shape: Optional[Tuple[int, int]] = None,
                      dtype=None, lazy: bool = True):
        """Lower to the compiled layer's application contract
        (:class:`~repro_torch.core.schedule.BlockPTGSpec`) — feed it to
        ``build_block_program`` exactly like a hand-written spec.

        ``lazy=True`` (the default) derives one :class:`LocalView` per
        shard (:meth:`derive_local`) instead of building the global edge
        dicts: the spec's ``ptg`` / ``operands`` / ``block_of`` dispatch
        every query to the owning shard's view, its ``seeds`` are the
        per-view seeds merged back into global program order, and
        ``spec.views`` routes ``build_block_program`` through
        :func:`~repro_torch.core.discovery.discover_local`. ``lazy=False`` keeps
        the eager global derivation — the validation oracle the lazy path
        is tested against (edge-for-edge, ``tests/test_torch_ptg.py``).
        """
        from repro_torch.core.schedule import BlockPTGSpec

        if not lazy:
            self.build()
            return BlockPTGSpec(
                ptg=self.to_ptg(), seeds=self.seeds, n_shards=self.n_shards,
                block_shape=block_shape or self.block_shape,
                block_of=self.block_of, operands=self.operands,
                owner=self.owner, dtype=dtype or self.dtype)

        views = self.local_views()
        home: Dict[K, LocalView] = {k: v for v in views for k in v.tasks}

        def _view(k: K) -> LocalView:
            try:
                return home[k]
            except KeyError:
                raise KeyError(f"unknown task {k!r} in graph {self.name!r}")

        ptg = union_ptg(views, home=home)
        seeds = [k for _, k in sorted(
            ((v.pos[k], k) for v in views for k in v.seeds),
            key=lambda e: e[0])]
        return BlockPTGSpec(
            ptg=ptg, seeds=seeds, n_shards=self.n_shards,
            block_shape=block_shape or self.block_shape,
            block_of=lambda k: _view(k).block_of(k),
            operands=lambda k: _view(k).operands(k),
            owner=self.owner, dtype=dtype or self.dtype, views=views)

    def to_program(self, *, validate: bool = False, lazy: bool = True):
        """Discover + lower to a :class:`~repro_torch.core.schedule.BlockProgram`
        (per-wavefront tables + classified comm plan), ready for
        ``auto_executor``. ``lazy`` selects the derivation
        (:meth:`to_block_spec`); the resulting program is identical either
        way."""
        from repro_torch.core.schedule import build_block_program

        return build_block_program(self.to_block_spec(lazy=lazy),
                                   validate=validate)

    def executor(self, bodies, *, device="cuda", validate: bool = False,
                 **policy):
        """One-call lowering: discover, build the program, and return its
        executor on ``device`` under the shared auto policy
        (``BlockProgram.plan_lowering``) — unrolled below ``unroll_cap``,
        segmented scan above it, pure dense scan only for genuinely dense or
        fragmented schedules. ``policy`` kwargs (``unroll_cap``/``comm``/
        ``overlap``/``segment_cap``/``density_threshold``) pass through to
        ``auto_executor``."""
        return self.to_program(validate=validate).auto_executor(
            bodies, device=device, **policy)

    def to_schedule(self, *, validate: bool = False,
                    lazy: bool = True) -> WavefrontSchedule:
        """Just the parallel-discovery schedule (wavefronts + comm plan).
        ``lazy=True`` (default) discovers through per-shard
        :class:`LocalView`'s (``discover_local``); ``lazy=False`` through
        the eagerly built global PTG — identical schedules either way."""
        if lazy:
            return discover_local(self.local_views(), self.n_shards,
                                  validate=validate)
        self.build()
        return discover(self.to_ptg(), self.seeds, self.n_shards,
                        validate=validate)

    def to_taskflow(self, ctx, store, bodies, *, name: Optional[str] = None,
                    device=None):
        """Host-runtime lowering for one emulated rank: a wired
        :class:`~repro_torch.core.taskflow.Taskflow` whose task bodies
        compute on ``store`` (tensor blocks on ``device``) and whose
        cross-rank out-edges send active messages, all generated from the
        derived edges. Returns ``(taskflow, seed_fn)``; call ``seed_fn()``
        to fulfill this rank's seeds, then join the threadpool."""
        from repro_torch.linalg.host_exec import wire_taskflow

        return wire_taskflow(ctx, self.to_block_spec(), store, bodies,
                             name=name or self.name, device=device)

    def run_host(self, blocks, bodies, *, n_threads: int = 2,
                 timeout: float = 120.0, faults=None, transport=None,
                 device="cuda"):
        """Execute on the host TaskTorrent runtime (async tasks + active
        messages) across ``n_shards`` emulated ranks, each with a block
        store on ``device``; returns the written blocks as tensors on
        ``device``, after a ``torch.cuda.synchronize`` there. ``transport``
        picks the comm backend the ranks run on (``inproc`` threads by
        default; ``multiproc`` puts every rank in its own OS process and
        takes ``device="cpu"`` only).

        With ``faults`` (a :class:`~repro_torch.core.faults.FaultPlan`) the
        run goes through the fault-tolerant host runtime and returns
        ``(blocks, RecoveryReport)``: shard adoption after a declared death
        re-runs :meth:`derive_local` for the moved shard only — the view's
        ``derived_edges`` over the all-shards total is the report's
        ``rederived_frac``, the measured lazy-recovery payoff."""
        from repro_torch.linalg.host_exec import run_host_ptg

        spec = self.to_block_spec()
        if faults is None:
            return run_host_ptg(spec, blocks, bodies,
                                n_threads=n_threads, timeout=timeout,
                                transport=transport, device=device)
        total = sum(v.stats.get("derived_edges", 0)
                    for v in self.local_views())
        return run_host_ptg(spec, blocks, bodies,
                            n_threads=n_threads, timeout=timeout,
                            faults=faults, rederive=self.derive_local,
                            total_edges=total, transport=transport,
                            device=device)

    def __repr__(self) -> str:
        state = (f"{len(self._tasks)} tasks, {len(self._seeds)} seeds"
                 if self._built else "unbuilt")
        return (f"Graph({self.name!r}, n_shards={self.n_shards}, "
                f"types={list(self._types)}, {state})")


def checked_ptg(in_deps: Callable[[K], Sequence[K]],
                out_deps: Callable[[K], Sequence[K]],
                mapping: Callable[[K], int],
                type_of: Callable[[K], str] = lambda k: "task",
                *, sample_keys: Sequence[K] = ()) -> PTG:
    """Wrap user-supplied edge rules (the unbounded-index-space escape
    hatch, where enumeration — and therefore the :class:`Graph` builder —
    is impossible) into a PTG, validating the mutual-inverse property on
    ``sample_keys`` up front. ``discover(..., validate=True)`` re-checks
    every task it actually expands."""
    ptg = PTG(in_deps=in_deps, out_deps=out_deps, mapping=mapping,
              type_of=type_of)
    if sample_keys:
        ptg.check_consistency(sample_keys)
    return ptg
