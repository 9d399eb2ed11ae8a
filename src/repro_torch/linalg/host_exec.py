"""Run a BlockPTGSpec on the *host* TaskTorrent runtime (async, AM-driven):
the port's copy of the JAX package's ``repro.linalg.host_exec``, on tensor
block stores.

This is the paper's example program (§II-A3) generalized: every rank owns its
blocks, a Taskflow executes tasks whose bodies compute on the rank's block
store, and each cross-rank out-dependency sends an active message carrying
the produced block which stores the payload and fulfills the remote promise.

**Stores on a device.** Each rank's store holds ``torch.Tensor`` blocks on
``device`` (``"cuda"`` unless the caller passes ``"cpu"``): the caller's
blocks (numpy arrays or tensors) are copied there once, and every block
stays there from then on. Bodies are torch functions on that device (B1
through ``kernels.block_gemm.ops.matmul`` on the card), or numpy bodies
wrapped to return CPU tensors (``linalg.cholesky.cholesky_bodies_numpy``,
for the fork-based ``multiproc`` transport). A body that returns a block on
another device raises; nothing is moved through the host quietly. AM
payloads are tensors and travel as on-device copies (see
:mod:`repro_torch.core.messages`), so under ``inproc`` a CUDA block never
leaves the card. ``multiproc`` takes CPU stores only.

**One stream.** Every body runs on the device's default stream, whichever
worker thread launches it. A consumer task is launched only after its
producer's body returned on the host (its promise is fulfilled after the
store), so stream order carries every dependence, across ranks too (the AM
payload's clone is on the same stream). Per-worker streams would need an
event per stored block.

The exact same :class:`~repro_torch.core.schedule.BlockPTGSpec` also lowers
to the compiled block executor — tests assert both agree, which is the
reproduction's core correctness claim: one PTG, two runtimes.
``wire_taskflow`` is the per-rank wiring generator; it is also what
``repro_torch.ptg.Graph.to_taskflow`` emits, so declaratively-built graphs
and hand-written specs share one host lowering.

Fault-tolerant mode (``run_host_ptg(..., faults=FaultPlan(...))``) swaps the
per-rank wiring for a :class:`_FaultHost`, which adds the recovery half of
the runtime on top of the reliable transport in ``core.messages``:

- **one dispatcher AM per rank**, registered up front — adoption must not
  register new AMs mid-run (registration order is the global AM identity,
  §II-B2), so every hosted shard shares the dispatcher;
- **application-level dedup** keyed ``(consumer task, producer task)``:
  transport retransmits are deduped by seq, but *recovery re-execution*
  legitimately re-produces the same fulfillment from a different host, and
  it must decrement each promise exactly once;
- a **send log** of cross-shard fulfillments. When a death declaration
  reassigns shards, every survivor replays its logged sends to the moved
  shards — payloads re-read from the block store, which is sound because
  communicated blocks are single-assignment (the block contract
  ``core.schedule`` checks): the stored value IS the value every consumer
  must observe;
- **adoption**: the assigned survivor re-derives the dead shard's
  :class:`~repro_torch.ptg.graph.LocalView` (the ``rederive`` hook —
  O(owned + halo), the lazy-discovery payoff), seeds its initial blocks,
  wires it as a second Taskflow on the same threadpool, and re-executes it
  from the seeds; upstream state arrives via the survivors' replays and
  every re-produced cross-shard fulfillment is deduped at its consumer.
  Deterministic bodies + single assignment make the result bit-identical
  to the fault-free run.

Misrouted AMs (sent on a stale route while a declaration propagates) are
forwarded along the receiver's current route — and logged, so a further
move replays them too.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from repro_torch.core.comm import get_backend
from repro_torch.core.faults import FaultPlan
from repro_torch.core.runtime import run_ranks
from repro_torch.core.schedule import BlockPTGSpec
from repro_torch.core.taskflow import Taskflow

K = Hashable


def store_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``cuda`` is the
    current CUDA device); raises when CUDA is asked for and no GPU is
    present (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but torch sees "
                               "no CUDA GPU; pass device='cpu' to run on the "
                               "host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def ranks_device(device, transport: Optional[str]) -> torch.device:
    """:func:`store_device` for ranks on ``transport``: a transport whose
    ranks are forked processes (``multiproc``) pickles its payloads and
    takes the CPU only, so any other device raises ``ValueError``."""
    dev = torch.device(device)
    backend = get_backend(transport)
    if dev.type != "cpu" and not backend.carries_device_tensors:
        raise ValueError(
            f"transport {backend.name!r} runs each rank in a forked process "
            f"and carries host payloads only; it cannot run a store on "
            f"{dev}. Use transport='inproc' on the device, or device='cpu' "
            "with numpy bodies")
    return store_device(dev)


def to_store(arr, device: torch.device) -> torch.Tensor:
    """A caller's block (numpy array or tensor) as a fresh tensor on
    ``device``: the store's own copy, never an alias of the caller's."""
    return torch.as_tensor(arr).to(device, copy=True)


def as_block(out, device: Optional[torch.device]) -> torch.Tensor:
    """A body's result as a store block: a tensor on the store's device. A
    numpy result is taken as a CPU tensor without a copy; a result on any
    other device than the store's raises."""
    if not isinstance(out, torch.Tensor):
        out = torch.as_tensor(out)
    if device is not None and out.device != device:
        raise ValueError(f"a task body returned a block on {out.device}, but "
                         f"the store lives on {device}; bodies must compute "
                         "on the store's device")
    return out


def wire_taskflow(
    ctx,
    spec: BlockPTGSpec,
    store: Dict[Hashable, torch.Tensor],
    bodies: Dict[str, Callable[..., torch.Tensor]],
    *,
    name: str = "ptg",
    device=None,
) -> Tuple[Taskflow, Callable[[], None]]:
    """Generate one rank's host-runtime wiring for ``spec``.

    Builds a :class:`Taskflow` whose
    - ``indegree`` comes from the spec's in-edges (seeds carry one
      synthetic dependency, fulfilled by the seed function);
    - task body gathers operands from ``store``, runs the type's compute
      body, stores the written block, and walks the *derived out-edges*:
      local consumers get ``fulfill_promise``, remote consumers get a
      one-sided active message carrying the block iff they read it.

    ``device`` (optional) is the store's device: a body result elsewhere
    raises (see :func:`as_block`).

    Returns ``(taskflow, seed_fn)``; the caller seeds and joins:

        tf, seed = wire_taskflow(ctx, spec, store, bodies)
        seed()
        ctx.tp.join()
    """
    ptg, n = spec.ptg, spec.n_shards
    rank = ctx.rank
    dev = None if device is None else store_device(device)
    tf = ctx.taskflow(name)
    am_holder = {}

    tf.set_indegree(lambda k: max(len(ptg.in_deps(k)), 1))
    # distributed mapping -> rank; thread mapping spreads dep management
    tf.set_mapping(lambda k: hash(k) % ctx.tp.n_threads)

    def body(k):
        ops = [store[blk] for blk in spec.operands(k)]
        out = as_block(bodies[ptg.type_of(k)](*ops), dev)
        store[spec.block_of(k)] = out
        for d in ptg.out_deps(k):
            dest = ptg.mapping(d) % n
            if dest == rank:
                tf.fulfill_promise(d)
            else:
                # the AM carries the block iff the consumer reads it
                payload = (out if spec.block_of(k) in set(spec.operands(d))
                           else None)
                am_holder["am"].send(dest, d, spec.block_of(k), payload)

    tf.set_task(body)

    def on_am(d, blk, payload):
        if payload is not None:
            store[blk] = payload  # already this rank's on-device copy
        tf.fulfill_promise(d)

    am_holder["am"] = ctx.comm.make_active_msg(on_am)

    def seed():
        for k in spec.seeds:
            if ptg.mapping(k) % n == rank:
                tf.fulfill_promise(k)

    return tf, seed


class _SpecEdges:
    """Edge queries for one shard answered by the global spec — the
    fallback adopter path when no ``rederive`` hook is available (the spec
    dispatches any task's queries, so hosting a foreign shard just works;
    it only forgoes the measured fresh re-derivation)."""

    def __init__(self, spec: BlockPTGSpec, shard: int):
        self._spec = spec
        self._ptg = spec.ptg
        self._n = spec.n_shards
        self.seeds = [k for k in spec.seeds
                      if self._ptg.mapping(k) % self._n == shard]

    def in_deps(self, k):
        return self._ptg.in_deps(k)

    def out_deps(self, k):
        return self._ptg.out_deps(k)

    def mapping(self, k):
        return self._ptg.mapping(k)

    def type_of(self, k):
        return self._ptg.type_of(k)

    def operands(self, k):
        return self._spec.operands(k)

    def block_of(self, k):
        return self._spec.block_of(k)


class _FaultHost:
    """One rank's fault-tolerant host runtime: its own shard plus any shard
    it adopts after a death declaration (see module docstring)."""

    def __init__(self, ctx, spec: BlockPTGSpec, blocks, bodies,
                 rederive: Optional[Callable] = None, *, device):
        self.ctx = ctx
        self.rank = ctx.rank
        self.spec = spec
        self.n = spec.n_shards
        self.device = store_device(device)
        self.bodies = bodies
        self.blocks_init = blocks  # global initial blocks (adoption seeds)
        self.rederive = rederive
        self.report = ctx.comm.world.report
        self.lock = threading.RLock()
        # shard -> hosting rank; identical on every rank (driven by the
        # DEATH assignment broadcast). Task->shard (spec.ptg.mapping) is
        # immutable; only shard->host moves.
        self.route: List[int] = list(range(self.n))
        self.hosted: Dict[int, Tuple[Taskflow, object]] = {}
        self.applied: set = set()  # (consumer, producer) fulfillments seen
        # (dest_shard, consumer, producer, block, has_payload)
        self.sendlog: List[tuple] = []
        self.store: Dict[Hashable, torch.Tensor] = {
            blk: to_store(arr, self.device) for blk, arr in blocks.items()
            if spec.owner(blk) % self.n == self.rank}
        # the single dispatcher AM — registered before any fault can strike
        self.am = ctx.comm.make_active_msg(self._on_am)
        self._wire_shard(self.rank, self._edges_for(self.rank, fresh=False),
                         adopted=False)
        ctx.comm.on_reconfigure = self._reconfigure

    # ------------------------------------------------------------ wiring

    def _edges_for(self, shard: int, *, fresh: bool):
        if fresh and self.rederive is not None:
            view = self.rederive(shard)  # fresh LocalView: O(owned + halo)
            self.report.note_rederived(
                shard, view.stats.get("derived_edges", 0))
            return view
        if fresh:
            self.report.note_rederived(shard, 0)
        return _SpecEdges(self.spec, shard)

    def _shard_of(self, k) -> int:
        return self.spec.ptg.mapping(k) % self.n

    def _wire_shard(self, shard: int, E, *, adopted: bool) -> Taskflow:
        tf = self.ctx.taskflow(f"ptg@s{shard}")
        tf.set_indegree(lambda k: max(len(E.in_deps(k)), 1))
        tf.set_mapping(lambda k: hash(k) % self.ctx.tp.n_threads)

        def body(k):
            ops = [self.store[blk] for blk in E.operands(k)]
            out = as_block(self.bodies[E.type_of(k)](*ops), self.device)
            blk = E.block_of(k)
            self.store[blk] = out
            if adopted:
                self.report.bump("reexecuted_tasks")
            for d in E.out_deps(k):
                ds = E.mapping(d) % self.n
                if ds == shard:
                    tf.fulfill_promise(d)
                else:
                    # consumer-side read set answered by the global spec
                    # (the producer's derived edge carries it on a real
                    # distributed system)
                    payload = (out if blk in set(self.spec.operands(d))
                               else None)
                    self._deliver(ds, d, k, blk, payload)

        tf.set_task(body)
        with self.lock:
            self.hosted[shard] = (tf, E)
        return tf

    def seed(self) -> None:
        tf, E = self.hosted[self.rank]
        for k in E.seeds:
            tf.fulfill_promise(k)

    # --------------------------------------------------------- data plane

    def _deliver(self, ds: int, d, k, blk, payload) -> None:
        """Route one cross-shard fulfillment (and log it for replay)."""
        with self.lock:
            self.sendlog.append((ds, d, k, blk, payload is not None))
            tgt = self.route[ds]
        if tgt == self.rank:
            self._apply(d, k, blk, payload)
        else:
            self.am.send(tgt, d, k, blk, payload)

    def _on_am(self, d, k, blk, payload) -> None:
        self._apply(d, k, blk, payload)

    def _apply(self, d, k, blk, payload) -> None:
        """Deliver one cross-shard fulfillment to a locally hosted shard,
        exactly once per (consumer, producer) pair."""
        ds = self._shard_of(d)
        with self.lock:
            entry = self.hosted.get(ds)
            if entry is not None:
                if (d, k) in self.applied:
                    return  # re-execution or replay duplicate
                self.applied.add((d, k))
                if payload is not None:
                    self.store[blk] = payload
                tf = entry[0]
        if entry is None:
            # Stale route: we got traffic for a shard we don't host — e.g.
            # a survivor's replay raced ahead of our own DEATH processing.
            # Cache the payload (single assignment: this IS the block's
            # final value) and forward along our route; the forward is
            # logged, so if our route is itself stale (the fenced dead
            # rank), our reconfigure replays it from the cached value.
            if payload is not None:
                with self.lock:
                    self.store[blk] = payload
            self.report.bump("forwarded_ams")
            self._deliver(ds, d, k, blk, payload)
            return
        tf.fulfill_promise(d)

    # ---------------------------------------------------------- recovery

    def _reconfigure(self, newly_dead, assignment, epoch) -> None:
        """Death declaration applied (progress thread): adopt what is ours,
        retarget the routes, replay logged sends to every moved shard."""
        with self.lock:
            changed = [s for s, h in assignment.items()
                       if self.route[s] != h]
            mine = [s for s in changed if assignment[s] == self.rank]
        # Wire adopted shards BEFORE exposing the new route: _apply checks
        # `hosted` first, so a route that says "me" always finds its
        # taskflow. Until the route flips, inbound traffic for these shards
        # forwards into the fenced void — and is replayed below.
        for s in mine:
            E = self._edges_for(s, fresh=True)
            for blk, arr in self.blocks_init.items():
                if self.spec.owner(blk) % self.n == s:
                    with self.lock:
                        # keep an already-received halo copy: communicated
                        # blocks are single-assignment, so it already holds
                        # the only value it will ever hold
                        self.store.setdefault(blk, to_store(arr,
                                                            self.device))
            tf = self._wire_shard(s, E, adopted=True)
            for k in E.seeds:
                tf.fulfill_promise(k)
        with self.lock:
            for s, h in assignment.items():
                self.route[s] = h
            entries = [e for e in self.sendlog if e[0] in set(changed)]
        for ds, d, k, blk, has_payload in entries:
            payload = self.store.get(blk) if has_payload else None
            if has_payload and payload is None:
                # a forwarded entry whose payload never lived here; the
                # producer's host (or its re-execution) replays it
                continue
            with self.lock:
                tgt = self.route[ds]
            if tgt == self.rank:
                self._apply(d, k, blk, payload)
            else:
                self.report.bump("replayed_sends")
                self.am.send(tgt, d, k, blk, payload)

    # ------------------------------------------------------------ results

    def owned_blocks(self) -> Dict[Hashable, torch.Tensor]:
        with self.lock:
            hosted = set(self.hosted)
        return {blk: arr for blk, arr in self.store.items()
                if self.spec.owner(blk) % self.n in hosted}


def run_host_ptg(
    spec: BlockPTGSpec,
    blocks: Dict[Hashable, object],
    bodies: Dict[str, Callable[..., torch.Tensor]],
    *,
    n_threads: int = 2,
    timeout: float = 120.0,
    faults: Optional[FaultPlan] = None,
    rederive: Optional[Callable] = None,
    total_edges: Optional[int] = None,
    transport: Optional[str] = None,
    device="cuda",
):
    """Execute the PTG on ``spec.n_shards`` emulated ranks with block
    stores on ``device``; returns all written blocks, as tensors on
    ``device`` (after a ``torch.cuda.synchronize`` there, so a caller's
    timing includes the device work) — or ``(blocks, RecoveryReport)`` when
    a :class:`~repro_torch.core.faults.FaultPlan` is given. ``rederive``
    (shard -> LocalView) lets adoption re-derive only the moved shard;
    ``total_edges`` is the eager-edge denominator for ``rederived_frac``.
    ``transport`` picks the comm backend (``inproc``/``multiproc``) the
    ranks run on; ``multiproc`` takes ``device="cpu"`` only (its forked
    ranks pickle their payloads, and CUDA does not survive the fork)."""
    n = spec.n_shards
    dev = ranks_device(device, transport)

    if faults is None:
        def main(ctx):
            rank = ctx.rank
            # rank-local store: owned blocks + halo copies received via AM
            store: Dict[Hashable, torch.Tensor] = {
                blk: to_store(arr, dev) for blk, arr in blocks.items()
                if spec.owner(blk) % n == rank
            }
            _, seed = wire_taskflow(ctx, spec, store, bodies, device=dev)
            seed()
            ctx.tp.join()
            # return only owned blocks (halo copies are transient)
            return {blk: arr for blk, arr in store.items()
                    if spec.owner(blk) % n == rank}

        results = run_ranks(n, main, n_threads=n_threads, timeout=timeout,
                            transport=transport)
        merged: Dict[Hashable, torch.Tensor] = {}
        for r in results:
            merged.update(r)
        _sync(dev)
        return merged

    def main(ctx):
        host = _FaultHost(ctx, spec, blocks, bodies, rederive, device=dev)
        host.seed()
        ctx.tp.join()
        return host.owned_blocks()

    results, report = run_ranks(n, main, n_threads=n_threads,
                                timeout=timeout, faults=faults,
                                transport=transport)
    report.total_edges = total_edges
    merged = {}
    for r in results:
        if r:  # killed ranks return None; their shards report elsewhere
            merged.update(r)
    _sync(dev)
    return merged, report


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
