"""Shared model layers: RMSNorm, RoPE, FFNs, initializers (PyTorch)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dtype)


def rope_freqs(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions [*] -> (cos, sin) each [*, dim/2] (f32)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., S, D]; cos/sin broadcastable to [..., S, D/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    while cos.dim() < x1.dim():
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
           w_out: torch.Tensor, product=torch.matmul) -> torch.Tensor:
    """The SwiGLU FFN; ``product`` takes the hidden activations through
    ``w_out`` (the tensor-parallel row product on a model axis)."""
    return product(F.silu(x @ w_gate) * (x @ w_in), w_out)


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
             product=torch.matmul) -> torch.Tensor:
    """The GELU (tanh) FFN; ``product`` as in :func:`swiglu`."""
    return product(F.gelu(x @ w_in, approximate="tanh"), w_out)


# Elements of an f32 draw for a narrower tensor (1 GiB): a bf16 matrix
# larger than this is drawn piece by piece, so its f32 draw is never whole
# in memory (an expert stack of grok-1 is 12.9 G elements).
DRAW = 1 << 28


def dense_init(gen: torch.Generator, shape: Sequence[int],
               in_axis: Optional[int] = 0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """LeCun-normal in the input dimension(s), drawn from ``gen`` (on the
    generator's device unless ``device`` is given). On the ``meta`` device
    nothing is drawn or allocated."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = 1
    for ax in range(len(shape) - 1) if in_axis is None else [in_axis]:
        fan_in *= shape[ax]
    device = gen.device if device is None else device
    n = math.prod(shape)
    if dtype == torch.float32 or n <= DRAW:
        return (torch.randn(tuple(shape), generator=gen, device=device)
                * fan_in ** -0.5).to(dtype)
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, n, DRAW):
        m = min(DRAW, n - i)
        flat[i:i + m] = torch.randn(m, generator=gen,
                                    device=device) * fan_in ** -0.5
    return out


def stacked_dense_init(gen: torch.Generator, n: int, shape: Sequence[int],
                       in_axis: int = 0, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """[n, *shape]: one independent init per layer (``in_axis`` indexes
    ``shape``)."""
    return dense_init(gen, (n, *shape), in_axis + 1, dtype, device)
