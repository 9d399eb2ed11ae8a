"""Parallel distributed DAG discovery from a PTG (§I-C of the paper: "the
DAG is discovered piece by piece, in parallel").

This module is standard-library Python. ``repro_torch`` keeps its own copy
of the JAX package's ``repro.core.discovery`` so that the port imports
nothing of that package; the two must stay equal in behaviour
(``tests/test_torch_ptg.py`` and ``tests/test_torch_schedule.py`` hold the
schedules and every table built from them against the JAX package).

The message-driven discovery runs symbolically, shard by shard:

- each shard expands only the frontier of tasks *mapped to it*;
- a cross-shard out-dependency emits a **discovery message** (the stand-in
  for the active message that carries the payload at run time);
- remote tasks enter a shard's frontier only when such a message arrives.

No shard ever enumerates the global index space. The output is a
:class:`WavefrontSchedule`: per-shard task lists leveled into wavefronts
plus a batched communication plan (cross-shard edges fused per
(wavefront, src, dst), the analogue of the paper's large active messages).

Two edge oracles drive the same loop:

- :func:`discover` — a global :class:`PTG` (eagerly derived edge dicts or
  hand-written edge rules);
- :func:`discover_local` — per-shard *lazy views*
  (:meth:`repro_torch.ptg.Graph.derive_local`), each holding edges only for
  its owned tasks + halo. :func:`union_ptg` is the PTG-protocol facade over
  such views for consumers that must follow an edge to its remote endpoint.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

K = Hashable


@dataclass(frozen=True)
class PTG:
    """A parametrized task graph with statically queryable edges.

    ``in_deps(k)``  — tasks k depends on (the static counterpart of
                      ``indegree``: ``indegree(k) == len(in_deps(k))``);
    ``out_deps(k)`` — tasks whose promises k fulfills;
    ``mapping(k)``  — shard owning k (the distributed mapping; the paper's
                      per-thread mapping becomes per-chip);
    ``type_of(k)``  — task-type tag (selects the compute body at lowering).
    """

    in_deps: Callable[[K], Sequence[K]]
    out_deps: Callable[[K], Sequence[K]]
    mapping: Callable[[K], int]
    type_of: Callable[[K], str] = lambda k: "task"

    def check_consistency(self, sample_keys: Sequence[K]) -> int:
        """Check the PTG contract on ``sample_keys``: ``in_deps``/``out_deps``
        are mutual inverses and ``mapping`` is stable (pure).

        A hand-written spec whose ``out_deps`` forgets an edge that
        ``in_deps`` declares silently drops the message that would carry the
        payload — the consumer just never runs (or reads garbage). Graphs
        built with :mod:`repro_torch.ptg` satisfy this by construction; this check
        gives hand-written specs the same guarantee. Returns the number of
        edges verified; raises ``ValueError`` naming the first broken edge.
        """
        checked = 0
        for k in sample_keys:
            if self.mapping(k) != self.mapping(k):
                raise ValueError(
                    f"mapping({k!r}) is unstable across calls; the runtime "
                    "would route fulfillments to different shards")
            ins = list(self.in_deps(k))
            if [repr(d) for d in ins] != [repr(d) for d in self.in_deps(k)]:
                raise ValueError(f"in_deps({k!r}) is unstable across calls")
            for d in ins:
                if not any(o == k for o in self.out_deps(d)):
                    raise ValueError(
                        f"in_deps({k!r}) contains {d!r} but out_deps({d!r}) "
                        f"does not contain {k!r}: the producer would never "
                        "fulfill (or send to) this task — its promise, and "
                        "any payload riding it, is silently dropped")
                checked += 1
            for d in self.out_deps(k):
                if not any(i == k for i in self.in_deps(d)):
                    raise ValueError(
                        f"out_deps({k!r}) contains {d!r} but in_deps({d!r}) "
                        f"does not contain {k!r}: the fulfillment would "
                        "over-decrement the consumer's dependency counter")
                checked += 1
        return checked


@dataclass
class Message:
    """A discovery/communication edge crossing shards: produced by ``src_task``
    on shard ``src`` at its wavefront, consumed by ``dst_task`` on ``dst``."""

    src: int
    dst: int
    src_task: K
    dst_task: K
    level: int = -1  # producer wavefront


@dataclass
class ShardSchedule:
    """One shard's discovered schedule: ``wavefronts[level]`` lists the
    tasks this shard runs at that level, in discovery order. ``expanded``
    counts the fulfill events the shard processed — the locality metric:
    it is O(owned tasks + halo edges), never O(global DAG)."""

    shard: int
    wavefronts: List[List[K]] = field(default_factory=list)  # level -> tasks
    expanded: int = 0  # tasks this shard touched during discovery (locality)


@dataclass(frozen=True)
class CommPattern:
    """Shape of one wavefront's exchange, classified from the message plan.

    The lowering picks its collective from this: a handful of active pairs
    (low ``density``) wants point-to-point ``ppermute`` rounds; a
    near-complete pair set amortizes better as one ``all_to_all``. The host
    runtime needs no such choice — its AMs are naturally sparse — so this
    classification is exactly what the compiled path must recover to match
    the paper's wire behavior.
    """

    level: int
    n_shards: int
    pair_counts: Dict[Tuple[int, int], int]  # (src, dst) -> messages

    @property
    def n_pairs(self) -> int:
        return len(self.pair_counts)

    @property
    def density(self) -> float:
        """Active fraction of the n·(n-1) possible off-diagonal pairs."""
        possible = self.n_shards * (self.n_shards - 1)
        return self.n_pairs / possible if possible else 0.0

    @property
    def max_pair(self) -> int:
        """Widest per-pair batch — the dense lowering pads every pair to it."""
        return max(self.pair_counts.values(), default=0)

    @property
    def total(self) -> int:
        return sum(self.pair_counts.values())

    def rounds(self) -> List[List[Tuple[int, int]]]:
        """Decompose the pair set into partial permutations (each shard sends
        to <= 1 dst and receives from <= 1 src per round) — the schedule of
        ``ppermute`` rounds for the sparse lowering. Greedy maximal matchings
        over the widest-first pair list: <= 2*max_degree - 1 rounds."""
        remaining = sorted(self.pair_counts,
                           key=lambda p: (-self.pair_counts[p], p))
        out: List[List[Tuple[int, int]]] = []
        while remaining:
            srcs: set = set()
            dsts: set = set()
            round_, rest = [], []
            for pair in remaining:
                s, d = pair
                if s in srcs or d in dsts:
                    rest.append(pair)
                else:
                    srcs.add(s)
                    dsts.add(d)
                    round_.append(pair)
            out.append(sorted(round_))
            remaining = rest
        return out

    def round_perms(self) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
        """The *static* structure of :meth:`rounds` — the per-round partial
        permutations as a hashable tuple. A scanned lowering walks one
        fixed ``ppermute`` permutation per round, so this is exactly the part
        of the pattern a scanned lowering must hold constant across the
        wavefronts it folds together (per-pair widths may differ — they pad)."""
        return tuple(tuple(r) for r in self.rounds())

    def signature(self, choice: str) -> Tuple:
        """Hashable *comm signature* of this wavefront's exchange under the
        lowering ``choice`` ("none" | "all_to_all" | "ppermute") — the
        segmentation key for the segmented-scan executor. Two wavefronts
        with equal signatures can share one scan body: same collective, and
        for ppermute the identical static round permutations (table widths
        are made compatible by per-segment padding)."""
        if choice == "none":
            return ("none",)
        if choice == "all_to_all":
            return ("all_to_all",)
        if choice == "ppermute":
            return ("ppermute", self.round_perms())
        raise ValueError(f"unknown lowering choice {choice!r}")


def union_pattern(patterns: Sequence["CommPattern"]) -> "CommPattern":
    """The *union permutation cover* of a run of comm patterns: per-pair
    counts are the pairwise max, so the union's :meth:`CommPattern.rounds`
    give a single static round structure every wavefront in the run can ride
    — a pair inactive at some wavefront simply ships trash padding there.

    This is what lets a fragmented run (every wavefront a different partial
    permutation, e.g. deep FFT's stride cycling) still lower to one
    scan: every step of the scan walks the union rounds, and each
    wavefront realizes its own slots on them. The padding cost is the
    inactive (pair, wavefront) slots — accounted honestly by
    ``BlockProgram.comm_stats(cover="union")``, and accepted by
    ``plan_lowering`` only when it still beats the dense-scan wire."""
    if not patterns:
        return CommPattern(level=0, n_shards=0, pair_counts={})
    pair_counts: Dict[Tuple[int, int], int] = {}
    for p in patterns:
        for pair, cnt in p.pair_counts.items():
            pair_counts[pair] = max(pair_counts.get(pair, 0), cnt)
    return CommPattern(level=patterns[0].level,
                       n_shards=patterns[0].n_shards,
                       pair_counts=dict(sorted(pair_counts.items())))


def segment_runs(items: Sequence[Hashable]) -> List[Tuple[int, int]]:
    """Partition ``[0, len(items))`` into maximal ``[start, stop)`` runs of
    equal items. The segmentation primitive shared by the segmented-scan
    executor (runs of equal comm signature -> one scan each)."""
    runs: List[Tuple[int, int]] = []
    for i, item in enumerate(items):
        if runs and items[runs[-1][0]] == item:
            runs[-1] = (runs[-1][0], i + 1)
        else:
            runs.append((i, i + 1))
    return runs


@dataclass
class WavefrontSchedule:
    """The complete output of parallel discovery: per-shard wavefront task
    lists (normalized to equal depth for the lockstep lowerings), the fused
    cross-shard message plan grouped by producer wavefront, and the global
    leveling ``level_of``. Invariant: every dependency is scheduled at a
    strictly earlier level than its dependents, and every cross-shard edge
    has exactly one message at the producer's level (:meth:`validate`)."""

    n_shards: int
    shards: List[ShardSchedule]
    # messages grouped by producer wavefront, then (src, dst) — one fused
    # "large AM" per group.
    messages: Dict[int, Dict[Tuple[int, int], List[Message]]]
    level_of: Dict[K, int]

    @property
    def n_wavefronts(self) -> int:
        return max((len(s.wavefronts) for s in self.shards), default=0)

    def comm_plan(self, level: int) -> Dict[Tuple[int, int], List[Message]]:
        """The batched exchange at one wavefront: ``{(src, dst): [Message]}``,
        deterministically ordered. All edges of a (src, dst) pair ride one
        fused buffer — the compiled analogue of the paper's *large AM*
        batching — so every lowering (the block executor's all_to_all and
        ppermute tables) derives its communication from this single plan
        rather than re-walking the PTG."""
        groups = self.messages.get(level, {})
        return {pair: list(groups[pair]) for pair in sorted(groups)}

    def comm_pairs(self, level: int) -> List[Tuple[int, int]]:
        """Just the (src, dst) pairs exchanging data at ``level`` — the
        collective-permute pattern for lockstep lowerings."""
        return sorted(self.messages.get(level, {}))

    def comm_pattern(self, level: int) -> CommPattern:
        """Classify the exchange at ``level``: per-pair message counts and
        pair density, from which a lowering picks sparse (ppermute rounds)
        vs dense (all_to_all) collectives."""
        groups = self.messages.get(level, {})
        return CommPattern(
            level=level, n_shards=self.n_shards,
            pair_counts={pair: len(groups[pair]) for pair in sorted(groups)})

    def halo_split(self, level: int) -> List[Tuple[List[K], List[K]]]:
        """Split each shard's tasks at wavefront ``level`` into
        (halo-independent, halo-dependent) sets wrt the arrivals of the
        *previous* wavefront's exchange.

        Halo-independent tasks consume no block landing at ``level - 1``'s
        exchange, so a double-buffered lowering may run them concurrently
        with that exchange — the compiled analogue of the paper's AM/compute
        overlap. Task order within each set preserves wavefront order."""
        arriving: set = set()
        for msgs in self.messages.get(level - 1, {}).values():
            for m in msgs:
                if self.level_of.get(m.dst_task) == level:
                    arriving.add(m.dst_task)
        out: List[Tuple[List[K], List[K]]] = []
        for s in self.shards:
            tasks = s.wavefronts[level] if level < len(s.wavefronts) else []
            indep = [k for k in tasks if k not in arriving]
            dep = [k for k in tasks if k in arriving]
            out.append((indep, dep))
        return out

    def validate(self, ptg: PTG) -> None:
        """Every dependency is scheduled strictly before its dependents, and
        every cross-shard edge has a message at the producer's level."""
        for k, lvl in self.level_of.items():
            for d in ptg.in_deps(k):
                assert self.level_of[d] < lvl, (d, k)
                if ptg.mapping(d) != ptg.mapping(k):
                    group = self.messages[self.level_of[d]][
                        (ptg.mapping(d), ptg.mapping(k))]
                    assert any(m.src_task == d and m.dst_task == k
                               for m in group), (d, k)


def _run_discovery(view_of: Callable[[int], object],
                   seed_pairs: Sequence[Tuple[K, int]],
                   n_shards: int) -> WavefrontSchedule:
    """The bulk-synchronous discovery loop shared by :func:`discover`
    (global PTG) and :func:`discover_local` (per-shard lazy views).

    ``view_of(s)`` returns the edge oracle shard ``s`` expands through —
    anything exposing ``in_deps`` / ``out_deps`` / ``mapping``. Shard ``s``
    only ever queries its own view, and only for tasks mapped to it plus
    the out-edge targets those tasks fulfill (the halo) — so a per-shard
    view never needs the global edge dicts. ``seed_pairs`` is the
    ``(task, shard)`` list of zero-indegree roots, per-shard in program
    order. Invariant: the schedule depends only on the edge *values* the
    views return, so any two view sets agreeing edge-for-edge produce
    identical wavefronts and message plans.
    """
    shards = [ShardSchedule(s) for s in range(n_shards)]
    # per-shard discovery state — *disjoint by construction*; a shard only
    # ever touches keys it owns (asserted in tests for locality).
    remaining: List[Dict[K, int]] = [dict() for _ in range(n_shards)]
    level_of: Dict[K, int] = {}
    messages: Dict[int, Dict[Tuple[int, int], List[Message]]] = defaultdict(
        lambda: defaultdict(list))

    # "fulfill" events pending per shard: (task, from_level)
    inbox: List[List[Tuple[K, int]]] = [[] for _ in range(n_shards)]
    for k, s in seed_pairs:
        inbox[s % n_shards].append((k, -1))

    round_ = 0
    while any(inbox):
        next_inbox: List[List[Tuple[K, int]]] = [[] for _ in range(n_shards)]
        for s in range(n_shards):
            view = view_of(s)
            sched = shards[s]
            ready: List[Tuple[K, int]] = []
            for k, from_level in inbox[s]:
                sched.expanded += 1
                cnt = remaining[s].get(k)
                if cnt is None:
                    cnt = len(view.in_deps(k))
                    cnt = max(cnt, 1)  # seeds carry one synthetic dep
                cnt -= 1
                lvl = level_of.get(k, -1)
                level_of[k] = max(lvl, from_level + 1)
                if cnt == 0:
                    remaining[s].pop(k, None)
                    ready.append((k, level_of[k]))
                else:
                    remaining[s][k] = cnt
            for k, lvl in ready:
                sched_lvl = lvl
                while len(sched.wavefronts) <= sched_lvl:
                    sched.wavefronts.append([])
                sched.wavefronts[sched_lvl].append(k)
                for d in view.out_deps(k):
                    ds = view.mapping(d) % n_shards
                    if ds != s:
                        messages[sched_lvl][(s, ds)].append(
                            Message(s, ds, k, d, level=sched_lvl))
                    next_inbox[ds].append((d, sched_lvl))
        inbox = next_inbox
        round_ += 1
        if round_ > 10_000_000:  # pragma: no cover
            raise RuntimeError("discovery did not converge (cyclic PTG?)")

    leftover = [k for s in range(n_shards) for k in remaining[s]]
    if leftover:
        raise ValueError(
            f"{len(leftover)} task(s) never became ready (unreachable deps or "
            f"wrong indegree), e.g. {leftover[:3]}")
    sched = WavefrontSchedule(n_shards, shards, dict(messages), level_of)
    # normalize: same number of wavefronts everywhere (lockstep lowering)
    depth = sched.n_wavefronts
    for s in shards:
        while len(s.wavefronts) < depth:
            s.wavefronts.append([])
    return sched


def discover(ptg: PTG, seeds: Sequence[K], n_shards: int, *,
             validate: bool = False) -> WavefrontSchedule:
    """Message-driven parallel discovery (run symbolically, shard-local)
    from a *global* PTG — every shard expands through the same edge oracle.

    Implemented as a bulk-synchronous emulation of the asynchronous runtime:
    at each round every shard independently expands the ready tasks it owns,
    posting discovery messages for remote out-edges; messages are delivered
    between rounds. Wavefront level(k) = 1 + max(level of deps) — the ALAP/
    ASAP leveling the lockstep lowering needs. Returns the
    :class:`WavefrontSchedule`; raises ``ValueError`` when tasks never
    become ready (wrong indegree / unreachable deps).

    ``validate=True`` additionally runs :meth:`PTG.check_consistency` over
    every discovered task, so hand-written in/out-edge pairs get the same
    mutual-inverse guarantee the :mod:`repro_torch.ptg` builder provides by
    construction.
    """
    sched = _run_discovery(lambda s: ptg,
                           [(k, ptg.mapping(k)) for k in seeds], n_shards)
    if validate:
        ptg.check_consistency(list(sched.level_of))
    return sched


def discover_local(views: Sequence, n_shards: int, *,
                   validate: bool = False) -> WavefrontSchedule:
    """The ``local=True`` discovery mode: the same message-driven loop as
    :func:`discover`, but shard ``s`` expands through ``views[s]`` — a
    lazily derived per-shard slice of the PTG
    (:meth:`repro_torch.ptg.Graph.derive_local`) that holds edges only for the
    tasks the shard owns plus their halo. No global edge dicts exist at any
    point; the union of what the views store is O(sum of owned + halo), and
    each shard's expansion cost is O(its tasks + halo edges).

    ``views[s]`` must expose ``in_deps`` / ``out_deps`` (complete for the
    shard's owned tasks), ``mapping`` (owned *and* halo tasks — out-edge
    targets are routed by the producer's view), ``seeds`` (owned
    zero-indegree tasks in program order), and ``shard``.

    Invariant (asserted by ``tests/test_lazy_discovery.py``): the returned
    schedule — per-shard wavefronts, levels, and fused message plans — is
    identical to ``discover`` over the eagerly derived global PTG.

    ``validate=True`` runs :meth:`PTG.check_consistency` over every
    discovered task through the :func:`union_ptg` of the views (the
    cross-shard dispatch needed to follow an edge to its other endpoint).
    """
    seed_pairs = [(k, view.shard) for view in views for k in view.seeds]
    sched = _run_discovery(lambda s: views[s], seed_pairs, n_shards)
    if validate:
        union_ptg(views).check_consistency(list(sched.level_of))
    return sched


def union_ptg(views: Sequence, home: Optional[Dict[K, object]] = None
              ) -> PTG:
    """A PTG-protocol facade over per-shard lazy views: each query is
    dispatched to the view *owning* the task, so the union behaves exactly
    like the eagerly derived global PTG without any shard's edge dicts
    being merged. The dispatch table is O(n_tasks) keys (comparable to the
    slot maps every lowering builds anyway) — the avoided global state is
    the O(n_edges) in/out dicts; pass a prebuilt ``home`` (task -> owning
    view) to share one table between callers. Raises ``KeyError`` for
    unknown tasks."""
    if home is None:
        home = {k: v for v in views for k in v.tasks}

    def _view(k: K):
        try:
            return home[k]
        except KeyError:
            raise KeyError(f"task {k!r} is owned by no shard view")

    return PTG(in_deps=lambda k: _view(k).in_deps(k),
               out_deps=lambda k: _view(k).out_deps(k),
               mapping=lambda k: _view(k).mapping(k),
               type_of=lambda k: _view(k).type_of(k))
