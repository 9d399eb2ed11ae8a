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
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple, Tuple

import torch

from .tree import leaves, tree_map


def _layer_scanned(fn: Callable, p: torch.Tensor, *rest: torch.Tensor
                   ) -> None:
    """``fn(p, *rest)`` on the whole leaf, or on each layer's slice of a
    stacked leaf (ndim >= 3 and every operand with p's leading dim) when
    ``REPRO_OPT_SCAN`` is on. ``fn`` updates its operands in place."""
    lead = p.shape[0] if p.ndim >= 3 else None
    if (os.environ.get("REPRO_OPT_SCAN", "1") != "1" or not lead
            or any(r.ndim < 1 or r.shape[0] != lead for r in rest)):
        fn(p, *rest)
        return
    for i in range(lead):
        fn(p[i], *(r[i] for r in rest))


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


@torch.no_grad()
def adafactor_update(params, grads, state: AdafactorState, *, lr=1e-3,
                     decay=0.8, eps=1e-30, clip=1.0):
    """One Adafactor step; params, vr and vc are updated in place. Returns
    (params, the new state)."""
    step, t = _next_step(state.step)
    beta = 1.0 - t ** -decay

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

    # _factored() depends only on rank, which the layer loop preserves (a
    # [L, a, b] leaf runs as [a, b] slices, still factored)
    for p, g, vr, vc in zip(*map(leaves,
                                 (params, grads, state.vr, state.vc))):
        _layer_scanned(upd_leaf, p, g, vr, vc)
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


__all__ = ["AdafactorState", "AdamWState", "adafactor_init",
           "adafactor_update", "adamw_init", "adamw_update",
           "make_optimizer", "opt_state_specs"]
