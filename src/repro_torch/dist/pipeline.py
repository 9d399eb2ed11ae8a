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
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.discovery import PTG, WavefrontSchedule
from ..ptg import Graph, IndexSpace


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

    ``pipeline_apply.wavefronts`` and ``pipeline_apply.stage_calls`` count
    the wavefronts walked and the ``stage_fn`` calls made."""
    axis = axis or mesh.axis_names[0]
    n_stages = mesh.shape[axis]
    n_micro = xs.shape[0]
    sched, perms = _plan(n_stages, n_micro)
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
