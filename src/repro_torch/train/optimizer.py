"""Optimizers: AdamW (f32 states) and Adafactor (factored second moments,
the giant-MoE memory policy).

The port of ``repro.train.optimizer``. State trees mirror the parameter
tree (dicts of tensors with the parameters' names) inside the reference's
NamedTuples. An update writes the new parameters and moments into their
tensors in place, under ``torch.no_grad()``, and returns them; the step
counter is a new 0-d int32 tensor on the parameters' device. The
arithmetic is the reference's, op for op, in f32.

Stacked leaves (ndim >= 3, every operand with the same leading dim) are
updated one layer at a time, as the reference scans them
(``REPRO_OPT_SCAN``, default on): the f32 temporaries stay one layer's
size. For Adafactor this changes the result: its update clip
``sqrt(mean(u²))`` is then taken per layer slice.

On a model axis of ranks each rank holds a box of each leaf
(``dist.tensor_parallel.shard_boxes``; Mamba-2's head-aligned leaves as
column pieces), and on the pipelined ranks each stage its layers of the
stacked leaves. AdamW is elementwise, so each rank updates its boxes
alone. :func:`ranked_adafactor_update` gives each rank its boxes of what
``adafactor_update`` gives the whole leaves, per layer slice as the layer
loop takes them: each statistic that spans the rank's box (the means of
g² over a split dim, the mean of ``vr`` over split rows, the clip's mean
of u²) is summed over the group that splits the leaf in f32, each box or
column piece counted by one of the ranks that hold it, one all-reduce per
leaf for all its slices.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .tree import leaf_paths, leaves, tree_map


def _slices(p: torch.Tensor, *rest: torch.Tensor) -> list:
    """The operands the update runs on: ``[(p, *rest)]``, or each layer's
    slices of a stacked leaf (ndim >= 3 and every operand with p's leading
    dim) when ``REPRO_OPT_SCAN`` is on."""
    lead = p.shape[0] if p.ndim >= 3 else None
    if (os.environ.get("REPRO_OPT_SCAN", "1") != "1" or not lead
            or any(r.ndim < 1 or r.shape[0] != lead for r in rest)):
        return [(p, *rest)]
    return [(p[i], *(r[i] for r in rest)) for i in range(lead)]


def _layer_scanned(fn: Callable, p: torch.Tensor, *rest: torch.Tensor
                   ) -> None:
    """``fn(p, *rest)`` on the whole leaf, or on each layer's slice of a
    stacked leaf (``_slices``). ``fn`` updates its operands in place."""
    for ops in _slices(p, *rest):
        fn(*ops)


def _next_step(step: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(step + 1, as an int32 tensor; it as f32)."""
    step = step + 1
    return step, step.float()


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr=3e-4, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step; params, m and v are updated in place. Returns
    (params, the new state)."""
    step, t = _next_step(state.step)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd_leaf(p, g, m, v):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        u = u + weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))

    for p, g, m, v in zip(*map(leaves, (params, grads, state.m, state.v))):
        _layer_scanned(upd_leaf, p, g, m, v)
    return params, AdamWState(step=step, m=state.m, v=state.v)


class AdafactorState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    vr: Any     # row second-moment factors (or full v for vectors)
    vc: Any     # col factors (a [1] placeholder for vectors)


def _factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2


def adafactor_init(params) -> AdafactorState:
    def vr(p):
        return torch.zeros(p.shape[:-1] if _factored(p) else p.shape,
                           dtype=torch.float32, device=p.device)

    def vc(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        vr=tree_map(vr, params), vc=tree_map(vc, params))


def _adafactor_leaf(beta, lr, eps, clip) -> Callable:
    """``upd_leaf(p, g, vr, vc)``: one-process Adafactor on a whole leaf
    or a layer slice of it, in place."""

    def upd_leaf(p, g, vr, vc):
        g = g.float()
        g2 = g * g + eps
        if _factored(p):
            vr.copy_(beta * vr + (1 - beta) * g2.mean(dim=-1))
            vc.copy_(beta * vc + (1 - beta) * g2.mean(dim=-2))
            r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
                     + eps)
        else:
            vr.copy_(beta * vr + (1 - beta) * g2)
            u = g / (torch.sqrt(vr) + eps)
        norm = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(norm / clip, min=1.0)
        p.copy_((p.float() - lr * u).to(p.dtype))

    return upd_leaf


@torch.no_grad()
def adafactor_update(params, grads, state: AdafactorState, *, lr=1e-3,
                     decay=0.8, eps=1e-30, clip=1.0):
    """One Adafactor step; params, vr and vc are updated in place. Returns
    (params, the new state)."""
    step, t = _next_step(state.step)
    upd_leaf = _adafactor_leaf(1.0 - t ** -decay, lr, eps, clip)
    # _factored() depends only on rank, which the layer loop preserves (a
    # [L, a, b] leaf runs as [a, b] slices, still factored)
    for p, g, vr, vc in zip(*map(leaves,
                                 (params, grads, state.vr, state.vc))):
        _layer_scanned(upd_leaf, p, g, vr, vc)
    return params, AdafactorState(step=step, vr=state.vr, vc=state.vc)


class Shard(NamedTuple):
    """How a rank holds a leaf (``ranked_adafactor_update``): the whole
    leaf's ``shape``, the dims of it of which the rank holds a part
    (``split``), whether the rank counts its box in the sums over the
    group (``counts``: one rank of those that hold the box), and for a
    leaf held as column pieces (Mamba-2's head-aligned leaves) the columns
    [lo, hi) of the rank's joined last dim that it counts (``cols``: a
    piece several ranks hold counts on one of them)."""
    shape: tuple
    split: frozenset
    counts: bool
    cols: Optional[tuple] = None


def _col_sum(t: torch.Tensor, cols) -> torch.Tensor:
    """``t`` summed over its last dim: over the columns ``cols`` only where
    given."""
    if cols is None:
        return t.sum(-1)
    return sum((t[..., lo:hi].sum(-1) for lo, hi in cols),
               torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device))


def _squares(u: torch.Tensor, cols) -> torch.Tensor:
    """sum(u²), over the columns ``cols`` only where given."""
    if cols is None:
        return torch.linalg.vector_norm(u) ** 2
    return sum((torch.linalg.vector_norm(u[..., lo:hi]) ** 2
                for lo, hi in cols), torch.zeros((), device=u.device))


@torch.no_grad()
def ranked_adafactor_update(params, grads, state: AdafactorState, *,
                            shards: dict, reduce: Callable, lr=1e-3,
                            decay=0.8, eps=1e-30, clip=1.0):
    """``adafactor_update`` on a rank's boxes of the leaves: ``params``,
    ``grads`` and ``state`` hold the rank's boxes (``grads`` already summed
    over the data group and the holders), ``shards`` a :class:`Shard` per
    leaf name, ``reduce(t)`` sums an f32 tensor over the group that splits
    the leaves (the model group; the pipe group of a pipelined mesh) in
    place. A leaf with no split dim, or split only along the layers that
    the layer loop runs over one at a time (``_slices``), runs the
    one-process arithmetic. Otherwise, per layer slice: the means of g²
    over a split dim, the mean of ``vr`` over split rows and the clip's
    mean of u² are sums over the group of each box's sums (a rank that does
    not count its box adds zeros; of a leaf of column pieces each rank adds
    its counted columns), over the whole leaf's sizes; the rest is
    elementwise on the box. One all-reduce per leaf for the row means or
    for the column means with the rows' ``vr`` sums (both only where both
    dims split), one for the clips; u is formed twice (for the clip, then
    for the update), so the f32 temporaries stay two of a slice's size.
    Returns (params, the new state)."""
    step, t = _next_step(state.step)
    beta = 1.0 - t ** -decay
    upd_leaf = _adafactor_leaf(beta, lr, eps, clip)

    def summed(t, sh):
        if not sh.counts:
            t.zero_()
        return reduce(t)

    def u_of(g, r, vc):
        """The unclipped update of a slice (``r`` is vr for a vector)."""
        g = g.float()
        if vc is None:
            return g / (torch.sqrt(r) + eps)
        u = torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
        return torch.div(g, u.add_(eps), out=u)

    for (name, p), g, vr, vc in zip(leaf_paths(params), *map(leaves, (
            grads, state.vr, state.vc))):
        sh = shards[name]
        parts = _slices(p, g, vr, vc)
        lead = p.dim() - parts[0][0].dim()      # 1: the layer loop's dim
        split = {d for d in sh.split if d >= lead}
        if not split:
            _layer_scanned(upd_leaf, p, g, vr, vc)
            continue
        factored = _factored(parts[0][0])
        last, second = p.dim() - 1 in split, p.dim() - 2 in split
        whole = 1                          # a slice's elements, whole
        for n in sh.shape[lead:]:
            whole *= n
        if factored:
            row, col = [], []
            for _, gi, _, _ in parts:
                g2 = gi.float().square().add_(eps)
                row.append(_col_sum(g2, sh.cols) if last
                           else g2.mean(dim=-1))
                col.append(g2.sum(-2) if second else g2.mean(dim=-2))
                del g2
            row = torch.stack(row).reshape(vr.shape)
            col = torch.stack(col).reshape(vc.shape)
            if last:
                row = summed(row, sh) / sh.shape[-1]
            vr.copy_(beta * vr + (1 - beta) * row)
            if second:
                both = summed(torch.cat([col.reshape(-1),
                                         vr.sum(dim=-1).reshape(-1)]), sh)
                col = both[:col.numel()].reshape(vc.shape) / sh.shape[-2]
                vr_mean = both[col.numel():].reshape(
                    vr.shape[:-1] + (1,)) / sh.shape[-2]
            else:
                vr_mean = vr.mean(dim=-1, keepdim=True)
            vc.copy_(beta * vc + (1 - beta) * col)
            parts = _slices(p, g, vr / torch.clamp(vr_mean, min=eps), vc)
        else:
            for _, gi, vri, _ in parts:
                vri.copy_(beta * vri + (1 - beta)
                          * gi.float().square().add_(eps))
            parts = [(pi, gi, vri, None) for pi, gi, vri, _ in parts]
        squares = torch.stack([_squares(u_of(gi, ri, vci), sh.cols)
                               for _, gi, ri, vci in parts])
        norms = torch.sqrt(summed(squares, sh) / whole)
        for (pi, gi, ri, vci), norm in zip(parts, norms):
            u = u_of(gi, ri, vci).div_(torch.clamp(norm / clip, min=1.0))
            pi.copy_(u.mul_(-lr).add_(pi))      # p - lr·u, rounded once
    return params, AdafactorState(step=step, vr=state.vr, vc=state.vc)


def make_optimizer(name: str):
    """(init, update) of ``adamw`` or ``adafactor``."""
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)


def opt_state_specs(params_specs, opt_name: str, abstract_params):
    """Sharding specs for the optimizer state, derived from the param specs
    (``dist.sharding.param_specs``) and the parameters (meta tensors or
    real ones): AdamW's m and v as the params, its step replicated;
    Adafactor's row factors drop the last dim's entry, its column factors
    the second last (vectors: vr as the param, vc ``P(None)``)."""
    from ..dist.sharding import P, map_tree

    if opt_name == "adamw":
        return AdamWState(step=P(), m=params_specs, v=params_specs)

    def entries(spec, p):
        return list(spec) + [None] * (p.dim() - len(spec))

    def vr_spec(spec, p):
        e = entries(spec, p)
        return P(*e[:-1]) if p.dim() >= 2 else P(*e)

    def vc_spec(spec, p):
        if p.dim() < 2:
            return P(None)
        e = entries(spec, p)
        return P(*(e[:-2] + e[-1:]))

    return AdafactorState(step=P(),
                          vr=map_tree(vr_spec, params_specs, abstract_params),
                          vc=map_tree(vc_spec, params_specs, abstract_params))


__all__ = ["AdafactorState", "AdamWState", "Shard", "adafactor_init",
           "adafactor_update", "adamw_init", "adamw_update",
           "make_optimizer", "opt_state_specs", "ranked_adafactor_update"]
