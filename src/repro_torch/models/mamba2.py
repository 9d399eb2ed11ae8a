"""Mamba-2 block (SSD): the full-sequence path through the SSD kernel
(``kernels.ssd_scan``) and the O(1)-state decode step.

Projection layout follows the Mamba-2 paper: one in-projection produces
[z | x | B | C | dt]; a depthwise causal conv runs over [x | B | C]; the SSD
scan mixes over time; gated RMSNorm and out-projection close the block.
Parameters are a dict of tensors with the JAX package's names and shapes.

The forward and the step take their sizes (d_inner, heads, groups) from
the weights they are given (``local_sizes``): on a model axis of ranks a
rank holds the z, x and dt columns of its heads and the B and C columns of
the groups they read (``dist.tensor_parallel``), its gated norm sums its
squares over the model group and ``w_out`` is all-reduced, and for
training the forward's input enters ``w_in`` through ``copy_to_model``;
on one process these are the config's sizes and the plain norm and
product.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from ..dist.tensor_parallel import (copy_to_model, group_rms_norm,
                                    row_product)
from ..kernels.ssd_scan.ops import ssd
from ..launch.flags import ssd_chunk


def mamba2_params_shapes(ssm: SSMConfig, d_model: int) -> dict:
    di = ssm.d_inner(d_model)
    nh = ssm.n_heads(d_model)
    g, n = ssm.n_groups, ssm.d_state
    conv_dim = di + 2 * g * n
    return {
        "w_in": (d_model, 2 * di + 2 * g * n + nh),  # z,x,B,C,dt
        "conv_w": (ssm.d_conv, conv_dim),            # depthwise causal conv
        "conv_b": (conv_dim,),
        "a_log": (nh,),
        "d_skip": (nh,),
        "dt_bias": (nh,),
        "norm_w": (di,),
        "w_out": (di, d_model),
    }


def head_columns(ssm: SSMConfig, d_model: int, model: int, coord: int,
                 leaf: str) -> List[Tuple[int, int]]:
    """Column ranges [lo, hi) of a leaf's last dim that rank ``coord`` of a
    model axis of ``model`` ranks holds, head-aligned: ``w_in`` [z | x | B
    | C | dt] the z, x and dt of its heads and the B and C of its groups;
    ``conv_w``, ``conv_b`` and the conv state ([x | B | C], ``"conv"``) its
    x, B and C; ``norm_w`` [di] its heads' channels; ``a_log``, ``d_skip``
    and ``dt_bias`` [nh] its heads. Its groups: ``n_groups / model`` where
    the axis divides them, else the one its heads read (head h reads group
    h // (nh / g))."""
    di, nh = ssm.d_inner(d_model), ssm.n_heads(d_model)
    g, n, m, r = ssm.n_groups, ssm.d_state, model, coord
    g0 = r * g // m
    g1 = (r + 1) * g // m if g % m == 0 else g0 + 1

    def own(size, at=0):
        return (at + r * size // m, at + (r + 1) * size // m)

    def groups(at):
        return (at + g0 * n, at + g1 * n)

    if leaf == "w_in":
        return [own(di), own(di, di), groups(2 * di),
                groups(2 * di + g * n), own(nh, 2 * di + 2 * g * n)]
    if leaf in ("conv_w", "conv_b", "conv"):
        return [own(di), groups(di), groups(di + g * n)]
    return [own(di if leaf == "norm_w" else nh)]


def local_sizes(p: Dict[str, torch.Tensor], ssm: SSMConfig
                ) -> Tuple[int, int, int]:
    """(d_inner, heads, groups) of a block's (local) weights: ``w_out``'s
    rows, those over the head dim, and the conv's channels past d_inner
    over 2·d_state. The config's on one process, a rank's own under tensor
    parallelism (``dist.tensor_parallel``: its heads and the groups they
    read)."""
    di = p["w_out"].shape[-2]
    return (di, di // ssm.head_dim,
            (p["conv_w"].shape[-1] - di) // (2 * ssm.d_state))


def _split(proj: torch.Tensor, p: Dict[str, torch.Tensor], ssm: SSMConfig):
    di, nh, g = local_sizes(p, ssm)
    n = ssm.d_state
    z, xbc, dt = proj.split([di, di + 2 * g * n, nh], dim=-1)
    return z, xbc, dt, di, g, n, nh


def mamba2_forward(x: torch.Tensor, p: Dict[str, torch.Tensor],
                   ssm: SSMConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] over the full sequence. The SSD runs as one
    kernel launch on CUDA tensors; x, B and C reach it as strided views of
    the convolved projection, with no copy. The sizes are those of ``p``'s
    (local) weights; the gated norm sums over the model group and
    ``w_out`` is a row-parallel product under tensor parallelism, whose
    replicated input enters ``w_in`` through ``copy_to_model``."""
    bsz, s, _ = x.shape
    proj = copy_to_model(x) @ p["w_in"]
    z, xbc, dt, di, g, n, nh = _split(proj, p, ssm)

    # depthwise causal conv over the sequence, summed in the JAX package's
    # order (in the compute dtype)
    pad = F.pad(xbc, (0, 0, ssm.d_conv - 1, 0))
    acc = pad[:, 0:s] * p["conv_w"][0]
    for i in range(1, ssm.d_conv):
        acc = acc + pad[:, i:i + s] * p["conv_w"][i]
    xbc = F.silu(acc + p["conv_b"])

    xs, b_mat, c_mat = xbc.split([di, g * n, g * n], dim=-1)
    xs = xs.unflatten(-1, (nh, ssm.head_dim))
    b_mat = b_mat.unflatten(-1, (g, n))
    c_mat = c_mat.unflatten(-1, (g, n))
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())

    y = ssd(xs, dt.to(xs.dtype), a, b_mat, c_mat, p["d_skip"].float(),
            q_chunk=ssd_chunk() or 128)
    y = y.reshape(bsz, s, di)
    y = group_rms_norm(y * F.silu(z), p["norm_w"])
    return row_product(y, p["w_out"])


class Mamba2State(NamedTuple):
    conv: torch.Tensor   # [B, d_conv-1, conv_dim]
    ssm: torch.Tensor    # [B, nh, N, P] (f32)


def mamba2_init_state(ssm: SSMConfig, d_model: int, batch: int,
                      dtype=torch.bfloat16, device="cuda") -> Mamba2State:
    di = ssm.d_inner(d_model)
    g, n = ssm.n_groups, ssm.d_state
    nh = ssm.n_heads(d_model)
    conv_dim = di + 2 * g * n
    return Mamba2State(
        conv=torch.zeros((batch, ssm.d_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, nh, n, ssm.head_dim), dtype=torch.float32,
                        device=device))


def mamba2_step(x: torch.Tensor, state: Mamba2State,
                p: Dict[str, torch.Tensor], ssm: SSMConfig
                ) -> Tuple[torch.Tensor, Mamba2State]:
    """Single-token decode: x [B, D] -> (y [B, D], new state). O(1) per
    token; no kernel (a few small elementwise products). Sizes, norm and
    ``w_out`` as in :func:`mamba2_forward`."""
    bsz = x.shape[0]
    proj = x @ p["w_in"]
    z, xbc, dt, di, g, n, nh = _split(proj, p, ssm)

    window = torch.cat([state.conv, xbc[:, None]], dim=1)
    conv_out = (window * p["conv_w"][None]).sum(dim=1) + p["conv_b"][None]
    xbc = F.silu(conv_out)
    new_conv = window[:, 1:]

    xs, b_mat, c_mat = xbc.split([di, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, nh, ssm.head_dim).float()
    rep = nh // g
    b_h = b_mat.reshape(bsz, g, n).float().repeat_interleave(rep, dim=1)
    c_h = c_mat.reshape(bsz, g, n).float().repeat_interleave(rep, dim=1)
    dt = F.softplus(dt.float() + p["dt_bias"][None].float())   # [B, nh]
    a = -torch.exp(p["a_log"].float())                           # [nh]

    decay = torch.exp(dt * a[None])                              # [B, nh]
    xdt = xs * dt[..., None]
    h_new = (decay[..., None, None] * state.ssm
             + b_h[..., :, None] * xdt[..., None, :])            # [B,nh,N,P]
    y = torch.einsum("bhn,bhnp->bhp", c_h, h_new)
    y = y + xs * p["d_skip"].float()[None, :, None]
    y = y.reshape(bsz, di).to(x.dtype)
    y = group_rms_norm(y * F.silu(z), p["norm_w"])
    return row_product(y, p["w_out"]), Mamba2State(conv=new_conv, ssm=h_new)
