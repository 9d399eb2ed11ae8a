"""Stage-parallel (pipeline) execution lowered from PTG discovery.

The port of ``repro.dist.pipeline``. The pipeline is expressed through the
``repro_torch.ptg`` builder as the same kind of parametrized task graph
every app declares: task (s, m) = "stage s applied to microbatch m" writes
activation block ("act", s, m) and reads ("act", s-1, m) (the hand-off),
with an ``after`` control edge (s, m-1) (a stage is a serial resource).
``discover`` levels this PTG into the GPipe trapezoid — wavefront(s, m) =
s + m, depth = n_stages + n_micro - 1 — and its ``comm_plan(w)`` is exactly
the set of (s, s+1) stage hand-offs live at step w.

On one device, ``pipeline_apply`` runs only the live tasks: it walks the
schedule's wavefronts in order, applies ``stage_fn`` to the (s, m) tasks
each holds and hands each output on through the wavefront's permutation
round. The reference's lockstep SPMD loop also computes a clipped
microbatch on every inactive stage and masks it away; those branches
reach neither the outputs nor the gradients, so skipping them gives the
same values, with exactly one ``stage_fn`` call per (stage, microbatch).

The backward comes from autograd: the hand-offs are plain tensor
references, so the gradient pipeline is the forward trapezoid mirrored.

On a mesh of ranks (``launch.mesh.Mesh(..., group=)``: one process per
mesh coordinate) each rank runs only its own stage's tasks, in the same
wavefront order, and each hand-off is a send from the stage the
wavefront's permutation round names to its pair, through the mesh's
transport (a device mailbox, or gloo staged through host memory). The
hand-off is an autograd ``Function``: its forward sends (or receives) the
activation, its backward sends the activation's gradient back over the
same pair, reversed. A stage's forward sends are asynchronous and
complete before ``pipeline_apply`` returns (on the device transport a
send waits only for room in the stage's mailbox, which its reader frees
in order); its backward receives block. So the gradient
pipeline is GPipe's (all forwards, then all backwards), and no rank can
wait on a peer that waits on it: in the forward a stage waits only on the
one before it, in the backward only on the one after it, and a stage
enters its backward after its last forward send has been issued. The
last stage alone holds the outputs (the reference ``psum``s them onto
every stage). A mesh of ranks with a model axis > 1 refuses
(``refuse_model_axis``): the reference's pipelined launcher runs with a
model axis of 1, and its ``pipeline_apply`` replicates a stage over
"model"; tensor-parallel training on ranks is the non-pipelined step's
(``train_step.make_train_step(cfg, mesh=)``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.discovery import PTG, WavefrontSchedule
from ..ptg import Graph, IndexSpace
from ..train.tree import leaves


def pipeline_graph(n_stages: int, n_micro: int) -> Graph:
    """The pipeline as a declarative ``repro_torch.ptg`` graph: task (s, m)
    writes activation block ("act", s, m) and reads the previous stage's
    hand-off ("act", s-1, m); the serial-resource edge (s, m-1) is a pure
    control ``after`` edge. Task keys are (stage, micro) tuples, and the
    space is partitioned by stage, so each stage's ``derive_local``
    enumerates its own microbatch row."""
    g = Graph("pipeline", n_shards=n_stages, owner=lambda blk: blk[1])
    g.task_type(
        "stage",
        space=IndexSpace(
            lambda: ((s, m) for s in range(n_stages)
                     for m in range(n_micro)),
            lambda shard: ((shard, m) for m in range(n_micro)),
            size=n_stages * n_micro),
        key=lambda s, m: (s, m),
        writes=lambda s, m: ("act", s, m),
        reads=lambda s, m: [("act", s - 1, m)] if s else [],
        after=lambda s, m: [(s, m - 1)] if m else [])
    return g


def pipeline_ptg(n_stages: int, n_micro: int) -> PTG:
    """The pipeline's parametrized task graph; task keys are (stage, micro)."""
    return pipeline_graph(n_stages, n_micro).to_ptg()


def pipeline_schedule(n_stages: int, n_micro: int) -> WavefrontSchedule:
    """Discover + level the pipeline PTG (one shard per stage) through the
    lazy per-shard derivation, with validation on."""
    return pipeline_graph(n_stages, n_micro).to_schedule(validate=True)


def schedule_depth(n_stages: int, n_micro: int) -> int:
    """Pipeline depth in wavefronts — the PTG-derived GPipe bubble:
    n_stages + n_micro - 1."""
    return pipeline_schedule(n_stages, n_micro).n_wavefronts


def split_microbatches(batch: Any, n_micro: int) -> Any:
    """Reshape every tensor [B, ...] of ``batch`` (a tensor or a dict of
    them) -> [n_micro, B // n_micro, ...]."""
    if isinstance(batch, dict):
        return {k: split_microbatches(v, n_micro) for k, v in batch.items()}
    b = batch.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    return batch.reshape(n_micro, b // n_micro, *batch.shape[1:])


def _stage_perms(sched: WavefrontSchedule) -> List[List[Tuple[int, int]]]:
    """Per-wavefront permutation rounds from the schedule's classified comm
    plan (each (src, dst) pair carries one hand-off). Every wavefront's
    pattern must be one partial permutation of multiplicity 1, and every
    stage but the first must feed from the previous wavefront's hand-off,
    so a pipeline PTG change that breaks that shape fails loudly instead
    of silently dropping hand-offs."""
    perms = []
    for w in range(sched.n_wavefronts):
        pat = sched.comm_pattern(w)
        rounds = pat.rounds()
        if pat.max_pair > 1 or len(rounds) > 1:
            raise ValueError(
                f"wavefront {w}: stage hand-offs must form one multiplicity-1"
                f" permutation round, got {pat.pair_counts}")
        for shard, (indep, _dep) in enumerate(sched.halo_split(w)):
            if shard > 0 and indep:
                raise ValueError(
                    f"wavefront {w}: stage {shard} has halo-independent "
                    f"tasks {indep}; pipeline stages must feed from the "
                    "previous stage's hand-off")
        perms.append(list(rounds[0]) if rounds else [])
    return perms


@functools.lru_cache(maxsize=None)
def _plan(n_stages: int, n_micro: int
          ) -> Tuple[WavefrontSchedule, List[List[Tuple[int, int]]]]:
    """The schedule and its permutation rounds, derived and validated once
    per (n_stages, n_micro): a train step reuses them every call."""
    sched = pipeline_schedule(n_stages, n_micro)
    return sched, _stage_perms(sched)


def _per_stage(stage_params: Any, n_stages: int) -> List[Any]:
    """Each stage's parameters: ``stage_params`` itself when it is already
    a list of ``n_stages`` stage trees, else its leaves (stacked per stage
    on dim 0) unbound once each."""
    if isinstance(stage_params, list):
        if len(stage_params) != n_stages:
            raise ValueError(f"{len(stage_params)} stage trees for "
                             f"{n_stages} stages")
        return stage_params

    def unbind(tree):
        if isinstance(tree, dict):
            parts = {k: unbind(v) for k, v in tree.items()}
            return [{k: v[s] for k, v in parts.items()}
                    for s in range(n_stages)]
        if tree.shape[0] != n_stages:
            raise ValueError(f"stage params stack {tree.shape[0]} stages, "
                             f"the mesh axis has {n_stages}")
        return list(tree.unbind(0))

    return unbind(stage_params)


def refuse_model_axis(mesh) -> None:
    """Raise ``ValueError`` on a mesh of ranks whose ``"model"`` axis is
    > 1: the reference's pipelined launcher builds its ("pipe", "data",
    "model") mesh with a model axis of 1, so the pipelined trainer runs
    the pipe and data axes on ranks only (a model axis trains on ranks
    without the pipeline: ``make_train_step(cfg, mesh=)``)."""
    if mesh.group is not None and mesh.shape.get("model", 1) > 1:
        raise ValueError(
            f"model axis {mesh.shape['model']} on ranks: the pipelined "
            "trainer runs the pipe and data axes on ranks, as the "
            "reference's pipelined launcher runs with model axis 1; train "
            "a model axis on ranks without --pipeline")


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, xs: torch.Tensor, *, mesh,
                   axis: Optional[str] = None,
                   scan_runs: bool = True) -> torch.Tensor:
    """Run ``n_micro`` microbatches through a stage-parallel pipeline.

    ``stage_params``: a tree whose leaves stack per stage on dim 0 (length
    = the mesh axis's size), or a list of one tree per stage; ``xs``:
    [n_micro, mb, ...] microbatched inputs; returns [n_micro, mb, ...] =
    stage_{S-1}(... stage_0(xs)) in ``xs``'s dtype, the values of applying
    the stages microbatch by microbatch. Differentiable.

    The wavefronts run in order, each task (s, m) of the schedule once:
    stage 0 reads ``xs[m]``, every later stage the hand-off it received
    through the previous wavefront's permutation round. ``scan_runs`` is
    accepted for the reference's signature and folds nothing: the
    reference folds runs of equal permutation into ``lax.scan`` to keep its
    program small, and a Python loop has no program size to keep small.

    On a mesh of ranks, ``stage_params`` is this rank's own stage tree
    (under grad every rank takes the gradient with respect to its stage's
    parameters: the previous stage waits for that backward), and only
    stage 0 reads ``xs``'s values: a later stage may pass a
    ``meta`` tensor of its shape and dtype, the shape and dtype of every
    hand-off. The last stage returns the outputs; any other stage returns
    a 0-d zero (f32) whose gradient runs this stage's backward: take the
    gradient of it where the last stage takes the loss's.

    ``pipeline_apply.wavefronts`` and ``pipeline_apply.stage_calls`` count
    the wavefronts walked and the ``stage_fn`` calls made (on ranks, this
    rank's own: the wavefronts that hold one of its tasks)."""
    axis = axis or mesh.axis_names[0]
    n_stages = mesh.shape[axis]
    n_micro = xs.shape[0]
    sched, perms = _plan(n_stages, n_micro)
    if mesh.group is not None:
        refuse_model_axis(mesh)
        return _apply_on_ranks(stage_fn, stage_params, xs, mesh, axis,
                               sched, perms)
    params = _per_stage(stage_params, n_stages)
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    inbox: Dict[int, Tuple[int, torch.Tensor]] = {}
    for w, perm in enumerate(perms):
        pipeline_apply.wavefronts += 1
        sent: Dict[int, Tuple[int, torch.Tensor]] = {}
        for shard in sched.shards:
            tasks = shard.wavefronts[w] if w < len(shard.wavefronts) else []
            for s, m in tasks:
                if s == 0:
                    x_in = xs[m]
                else:
                    got_m, x_in = inbox.pop(s)
                    if got_m != m:
                        raise RuntimeError(
                            f"stage {s} received microbatch {got_m}, its "
                            f"task at wavefront {w} is {m}")
                y = stage_fn(params[s], x_in).to(xs.dtype)
                pipeline_apply.stage_calls += 1
                if s == n_stages - 1:
                    outs[m] = y
                else:
                    sent[s] = (m, y)
        for src, dst in perm:          # the wavefront's fused hand-off
            inbox[dst] = sent.pop(src)
        if sent or (w == len(perms) - 1 and inbox):
            raise RuntimeError(f"wavefront {w}: hand-offs outside the comm "
                               f"plan from stages {sorted(sent)}")
    return torch.stack(outs)


pipeline_apply.wavefronts = 0
pipeline_apply.stage_calls = 0


class _Link:
    """One ranked ``pipeline_apply`` call's hand-offs: this stage's
    neighbours (global ranks), the hand-off's shape and dtype, and the
    backward sends still to issue (the last one completes them all)."""

    def __init__(self, transport, prev, nxt, shape, dtype, device,
                 n_micro):
        self.transport, self.prev, self.next = transport, prev, nxt
        self.shape, self.dtype, self.device = shape, dtype, device
        self.grads_to_send = n_micro if prev is not None else 0


class _Send(torch.autograd.Function):
    """Forward: send activation ``y`` of microbatch ``m`` to the next
    stage; returns a 0-d zero that carries the backward. Backward: receive
    ``y``'s gradient from the next stage. ``anchor`` (a 0-d leaf that
    requires grad) makes the output require grad whenever grad is on."""

    @staticmethod
    def forward(ctx, y, anchor, link, m):
        ctx.link, ctx.m = link, m
        link.transport.send(y, link.next, tag=m)
        return anchor.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        link = ctx.link
        g = link.transport.recv(link.shape, link.dtype, link.next,
                                tag=ctx.m)
        return g, None, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive the activation of microbatch ``m`` from the
    previous stage. Backward: send its gradient back to that stage; the
    last of the call's backward sends completes them all. The stage's
    parameters that require grad are inputs too (their gradient here is
    None): ``autograd.grad`` runs only the nodes on a path to the inputs
    it is asked for, and the previous stage waits for this backward."""

    @staticmethod
    def forward(ctx, link, m, anchor, *params):
        ctx.link, ctx.m = link, m
        return link.transport.recv(link.shape, link.dtype, link.prev,
                                   tag=m)

    @staticmethod
    def backward(ctx, g):
        link = ctx.link
        link.transport.send(g.to(link.dtype), link.prev, tag=ctx.m)
        link.grads_to_send -= 1
        if not link.grads_to_send:
            link.transport.wait_sends()
        return (None,) * len(ctx.needs_input_grad)


def _apply_on_ranks(stage_fn, params, xs, mesh, axis, sched, perms):
    """``pipeline_apply`` on this rank's stage of a mesh of ranks."""
    s, n_stages, n_micro = mesh.coords[axis], mesh.shape[axis], xs.shape[0]
    last = n_stages - 1
    link = _Link(mesh.transport,
                 mesh.line[axis][s - 1] if s else None,
                 mesh.line[axis][s + 1] if s < last else None,
                 tuple(xs.shape[1:]), xs.dtype,
                 xs.device if s == 0 else mesh.device, n_micro)
    anchor = torch.zeros((), device=link.device,
                         requires_grad=torch.is_grad_enabled())
    trained = [t for t in leaves(params) if t.requires_grad]
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    sent = []
    tasks = sched.shards[s].wavefronts
    for w, perm in enumerate(perms):
        mine = tasks[w] if w < len(tasks) else []
        if mine:
            pipeline_apply.wavefronts += 1
        for _, m in mine:
            if s == 0:
                x_in = xs[m]
            else:
                if (s - 1, s) not in perms[w - 1]:
                    raise RuntimeError(
                        f"wavefront {w}: stage {s} runs microbatch {m} "
                        "with no hand-off to it in the previous round")
                x_in = _Recv.apply(link, m, anchor, *trained)
            y = stage_fn(params, x_in).to(xs.dtype)
            pipeline_apply.stage_calls += 1
            if s == last:
                outs[m] = y
                continue
            if (s, s + 1) not in perm:
                raise RuntimeError(f"wavefront {w}: hand-off from stage "
                                   f"{s} outside the comm plan")
            sent.append(_Send.apply(y, anchor, link, m))
    link.transport.wait_sends()
    if s == last:
        return torch.stack(outs)
    return torch.stack(sent).sum()


def pipeline_loss_fn(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor],
                     *, mesh, n_micro: int, axis: Optional[str] = None):
    """``loss(stage_params, batch_x, batch_y)`` through the pipeline —
    microbatches the batch, pipelines the forward, applies ``loss_fn`` on
    the re-assembled outputs; gradients flow back through the pipeline by
    autograd."""

    def loss(stage_params, batch_x, batch_y):
        xs = split_microbatches(batch_x, n_micro)
        ys = pipeline_apply(stage_fn, stage_params, xs, mesh=mesh, axis=axis)
        yh = ys.reshape(batch_x.shape[0], *ys.shape[2:])
        return loss_fn(yh, batch_y)

    return loss


__all__ = ["pipeline_apply", "pipeline_graph", "pipeline_loss_fn",
           "pipeline_ptg", "pipeline_schedule", "schedule_depth",
           "split_microbatches"]
