"""Mixture-of-Experts layer: token-choice top-k with capacity (PyTorch).

The port of ``repro.models.moe``. Dispatch is decomposed into data-parallel
rows, as the reference's: the tokens reshape to [R, T, D] with R =
``dist.ctx.data_rows()`` (the product of the batch axes' sizes under a
mesh, 1 without one, and 1 when R does not divide the batch), and every
row is routed on its own — its own capacity, top-k, positions, [E, C, D]
expert buffers and combine — as the reference ``vmap``s over its rows.
The port loops over the rows. The steps that decide which tokens an
expert keeps follow the reference step for step, per row:

- router logits in f32 (from weights already cast to the compute dtype);
  ``"softmax"`` selects and weights by the softmax, ``"sigmoid"``
  (deepseek-v3, aux-loss-free) selects by affinity + ``router_bias`` and
  weights by the affinity;
- the top k, ties broken toward the lower expert index as ``lax.top_k``
  breaks them (a stable descending sort; ``torch.topk`` leaves the order
  of ties unspecified), renormalised by their sum + 1e-9;
- capacity ``int(T·k/E·cf) + 1`` from the row's T; a slot's position in
  its expert is the cumulative count over the token-major [T·k, E]
  one-hot; kept when ``pos < cap``;
- slot by slot scatter into [E, C, D] buffers in the compute dtype (a
  dropped slot adds zeros at (E-1, C-1)), a batched expert FFN, slot by
  slot combine in f32, then the shared experts.

On a mesh of ranks with a model axis (``dist.tensor_parallel``) a rank
holds its experts (or every expert's slice of the hidden dim), routes
every token of its row with the whole router and sums its combine over
the model group (``moe_ffn``); no all-to-all: every rank of a model group
holds the same tokens. Under grad the combine's sum is Megatron's g and
the layer's input enters through f (``transformer._mlp``): a rank's
gradients of the input and of the whole router come from its own slots
only, and the trainer sums the router's over the group
(``train_step.replica_leaves``); ``router_bias`` only selects, so its
gradient is zero, as on one process. The expert products are plain
batched matrix products (``torch.bmm``), as the JAX package computes them
outside any Pallas kernel. ``moe_ref`` is a plain version written apart
from the dispatch: it walks the experts one by one and runs one FFN per
expert on the tokens it keeps (one row).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..dist.ctx import annotate, batch_axes, data_rows
from ..dist.sharding import P
from ..dist.tensor_parallel import sum_partials, tp_mesh
from ..launch.flags import moe_capacity_factor


def moe_params_shapes(cfg_moe: MoEConfig, d_model: int, ffn: str) -> dict:
    e = cfg_moe.n_experts
    f = cfg_moe.d_ff
    shapes = {
        "router": (d_model, e),
        "router_bias": (e,),
        "w_in": (e, d_model, f),
        "w_out": (e, f, d_model),
    }
    if ffn == "swiglu":
        shapes["w_gate"] = (e, d_model, f)
    if cfg_moe.n_shared_experts:
        fs = f * cfg_moe.n_shared_experts
        shapes["shared_w_in"] = (d_model, fs)
        shapes["shared_w_out"] = (fs, d_model)
        if ffn == "swiglu":
            shapes["shared_w_gate"] = (d_model, fs)
    return shapes


class Routing(NamedTuple):
    """Where each token's k slots go: ``expert``, ``pos`` (its place in the
    expert's buffer) and ``weight`` [T, k]; ``keep`` [T, k] whether the slot
    fits the ``capacity``."""
    expert: torch.Tensor
    weight: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def _with_env(cfg_moe: MoEConfig) -> MoEConfig:
    """The config with ``REPRO_MOE_CF``'s capacity factor, when set."""
    cf = moe_capacity_factor()
    if cf is None:
        return cfg_moe
    return dataclasses.replace(cfg_moe, capacity_factor=cf)


def _scores(xt: torch.Tensor, p: dict, cfg_moe: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(selection scores, weight source) [T, E] in f32."""
    logits = xt.float() @ p["router"].float()
    if cfg_moe.router == "sigmoid":
        affinity = torch.sigmoid(logits)
        return affinity + p["router_bias"].float(), affinity
    select = torch.softmax(logits, dim=-1)
    return select, select


def capacity(t: int, cfg_moe: MoEConfig) -> int:
    """Slots per expert for ``t`` tokens."""
    return int(t * cfg_moe.experts_per_token / cfg_moe.n_experts
               * cfg_moe.capacity_factor) + 1


def route(xt: torch.Tensor, p: dict, cfg_moe: MoEConfig) -> Routing:
    """The dispatch of ``moe_ffn`` for tokens xt [T, D]."""
    cfg_moe = _with_env(cfg_moe)
    t, e, k = xt.shape[0], cfg_moe.n_experts, cfg_moe.experts_per_token
    select, weights_src = _scores(xt, p, cfg_moe)
    expert = torch.sort(select, dim=-1, descending=True,
                        stable=True).indices[:, :k]              # [T, k]
    weight = weights_src.gather(1, expert)
    weight = weight / (weight.sum(-1, keepdim=True) + 1e-9)
    cap = capacity(t, cfg_moe)
    flat = expert.reshape(-1, 1)                                 # [T*k, 1]
    onehot = torch.zeros((t * k, e), dtype=torch.int64, device=xt.device)
    onehot.scatter_(1, flat, 1)
    pos = (onehot.cumsum(0).gather(1, flat) - 1).reshape(t, k)
    return Routing(expert, weight, pos, pos < cap, cap)


def _expert_ffn(h: torch.Tensor, w: dict, ffn: str, prefix: str = "",
                f32_out: bool = False) -> torch.Tensor:
    """The FFN of one expert (h [C, D], 2-D weights) or of every expert at
    once (h [E, C, D], stacked weights). With ``f32_out`` the ``w_out``
    product is formed in f32 from the operands' values: a rank's partial
    over its slice of the hidden dim (``dist.tensor_parallel``)."""
    mm = torch.bmm if h.dim() == 3 else torch.matmul
    if ffn == "swiglu":
        a = F.silu(mm(h, w[prefix + "w_gate"])) * mm(h, w[prefix + "w_in"])
    else:
        a = F.gelu(mm(h, w[prefix + "w_in"]), approximate="tanh")
    if f32_out:
        return mm(a.float(), w[prefix + "w_out"].float())
    return mm(a, w[prefix + "w_out"])


def _add_shared(y: torch.Tensor, xt: torch.Tensor, p: dict,
                cfg_moe: MoEConfig, ffn: str, compute_dtype) -> torch.Tensor:
    """y [T, D] plus the shared experts' output, if the layer has any."""
    if not cfg_moe.n_shared_experts:
        return y
    return y + _expert_ffn(xt.to(compute_dtype), p, ffn, "shared_").to(
        y.dtype)


def dispatch_rows(x: torch.Tensor) -> int:
    """The dispatch rows of ``moe_ffn`` for x [B, S, D]: ``data_rows()``,
    or 1 when it does not divide B."""
    rows = data_rows()
    return 1 if x.shape[0] % rows else rows


def dispatch(x: torch.Tensor, p: dict, cfg_moe: MoEConfig
             ) -> Tuple[torch.Tensor, List[Routing]]:
    """(the tokens of x [B, S, D] as [R, T, D], each row's ``Routing``)."""
    b, s, d = x.shape
    rows = dispatch_rows(x)
    xt = annotate(x.reshape(rows, (b * s) // rows, d),
                  P(batch_axes(), None, None))
    return xt, [route(xt[r], p, cfg_moe) for r in range(rows)]


def _rows(parts: List[torch.Tensor]) -> torch.Tensor:
    """Per-row tensors stacked row first (a view of the one row's tensor
    when there is one)."""
    return parts[0][None] if len(parts) == 1 else torch.stack(parts)


def moe_ffn(x: torch.Tensor, p: dict, cfg_moe: MoEConfig, ffn: str,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D].

    Under tensor parallelism (``dist.tensor_parallel``) ``p`` holds the
    rank's shard of the expert banks: its ``E / model`` experts (expert
    parallelism), or, where the axis does not divide the experts, every
    expert's slice of the hidden dim. Every rank routes every token of its
    row with the whole router (the same call as on one process), scatters
    only the slots of its own experts into [E_local, C, D] buffers (the
    capacity is the whole E's; a slot that is dropped or not the rank's
    adds zeros at the rank's own dump slot), and its f32 combine is a
    partial: summed over the model group in one all-reduce with the shared
    experts' row-parallel partial (``sum_partials``), then rounded once."""
    b, s, d = x.shape
    e, k = cfg_moe.n_experts, cfg_moe.experts_per_token
    xt, routes = dispatch(x, p, cfg_moe)
    rows, t = xt.shape[:2]
    cap = routes[0].capacity
    mesh = tp_mesh()
    local = p["w_in"].shape[0]                    # this rank's experts
    first = mesh.coords["model"] * local if local < e else 0

    def mine(r: Routing, j: int) -> torch.Tensor:
        """Slot j of each token: kept, and in this rank's experts."""
        kj = r.keep[:, j]
        if local == e:
            return kj
        return kj & (r.expert[:, j] >= first) & (r.expert[:, j]
                                                 < first + local)

    # scatter, row by row and slot by slot: a kept slot owns its (expert,
    # pos) alone; a dropped one adds zeros at (E-1, C-1). On CUDA
    # ``index_put_`` with accumulate adds in no fixed order, but only that
    # dump slot receives more than one value, and all but one of them are
    # zeros, so the sum is exact whatever the order.
    bufs = []
    for x_r, r in zip(xt, routes):
        xin = torch.zeros((local, cap, d), dtype=compute_dtype,
                          device=x.device)
        xc = x_r.to(compute_dtype)
        for j in range(k):
            kj = mine(r, j)
            xin.index_put_((torch.where(kj, r.expert[:, j] - first,
                                        local - 1),
                            torch.where(kj, r.pos[:, j], cap - 1)),
                           torch.where(kj[:, None], xc, 0), accumulate=True)
        bufs.append(xin)
    xin = _rows(bufs)                                          # [R, E, C, D]
    xin = annotate(xin, P(batch_axes(), "model", None, None))

    # every row's buffers through the experts at once: [E, R·C, D] (a view
    # of the one row's [E, C, D] when R = 1); on hidden-dim shards the
    # w_out product is the rank's f32 partial
    yout = _expert_ffn(xin.transpose(0, 1).reshape(local, rows * cap, d), p,
                       ffn, f32_out=mesh is not None and local == e
                       ).reshape(local, rows, cap, d).transpose(0, 1)
    yout = annotate(yout, P(batch_axes(), "model", None, None))  # [R,E,C,D]

    # combine, row by row and slot by slot, in f32
    accs = []
    for yout_r, r in zip(yout, routes):
        acc = torch.zeros((t, d), dtype=torch.float32, device=x.device)
        for j in range(k):
            kj = mine(r, j)
            g = yout_r[torch.where(kj, r.expert[:, j] - first, 0),
                       torch.where(kj, r.pos[:, j], 0)]          # [T, D]
            acc += torch.where(kj[:, None], g, 0).float() \
                * r.weight[:, j, None]
        accs.append(acc)
    acc = _rows(accs).reshape(b * s, d)                        # [R·T, D]
    if mesh is None:
        y = _add_shared(acc.to(x.dtype), x.reshape(b * s, d), p, cfg_moe,
                        ffn, compute_dtype)
        return y.reshape(b, s, d)
    parts = [acc]
    if cfg_moe.n_shared_experts:
        parts.append(_expert_ffn(x.reshape(b * s, d).to(compute_dtype), p,
                                 ffn, "shared_", f32_out=True))
    sums = sum_partials(*parts)
    y = sums[0].to(x.dtype)
    if len(sums) > 1:
        y = y + sums[1].to(compute_dtype).to(y.dtype)
    return y.reshape(b, s, d)


def moe_ref(x: torch.Tensor, p: dict, cfg_moe: MoEConfig, ffn: str,
            compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``moe_ffn``: (y [B, S, D], keep [T, k]).

    Top-k by k rounds of ``argmax`` (the first of equal maxima) with the
    winner masked out; then expert by expert, the tokens routed to it in
    token order, of which the first ``capacity`` are kept, through that
    expert's own FFN, weighted into an f32 sum."""
    cfg_moe = _with_env(cfg_moe)
    b, s, d = x.shape
    t, e, k = b * s, cfg_moe.n_experts, cfg_moe.experts_per_token
    xt = x.reshape(t, d)
    select, weights_src = _scores(xt, p, cfg_moe)
    chosen = []
    masked = select.clone()
    for _ in range(k):
        best = masked.argmax(-1)
        chosen.append(best)
        masked.scatter_(1, best[:, None], float("-inf"))
    expert = torch.stack(chosen, 1)                              # [T, k]
    w = weights_src.gather(1, expert)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    cap = capacity(t, cfg_moe)
    keep = torch.zeros((t, k), dtype=torch.bool, device=x.device)
    acc = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    xc = xt.to(compute_dtype)
    for ex in range(e):
        hit = expert == ex                                       # [T, k]
        tokens = hit.any(1).nonzero()[:, 0][:cap]                # in order
        if tokens.numel() == 0:
            continue
        slot = hit[tokens].int().argmax(1)
        keep[tokens, slot] = True
        w_e = {n: p[n][ex] for n in ("w_in", "w_out", "w_gate") if n in p}
        y_e = _expert_ffn(xc[tokens], w_e, ffn)
        acc[tokens] += y_e.float() * w[tokens, slot][:, None]
    y = _add_shared(acc.to(x.dtype), xt, p, cfg_moe, ffn, compute_dtype)
    return y.reshape(b, s, d), keep


__all__ = ["Routing", "capacity", "dispatch", "dispatch_rows", "moe_ffn",
           "moe_params_shapes", "moe_ref", "route"]
