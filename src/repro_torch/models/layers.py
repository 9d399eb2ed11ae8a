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


def take_box(t, index):
    """``t[index]`` of one box (a tuple of step-1 slices, one per dim), or
    for a list of boxes that differ only in their last dim's slice, the
    boxes joined on the last dim (a copy; ``t`` a tensor or a numpy
    array): a rank's columns of a packed projection."""
    if not isinstance(index, list):
        return t[index]
    parts = [t[box] for box in index]
    if isinstance(t, torch.Tensor):
        return torch.cat(parts, dim=-1)
    import numpy as np

    return np.concatenate(parts, axis=-1)


def dense_init(gen: torch.Generator, shape: Sequence[int],
               in_axis: Optional[int] = 0, dtype=torch.float32,
               device=None, index=None) -> torch.Tensor:
    """LeCun-normal in the input dimension(s), drawn from ``gen`` (on the
    generator's device unless ``device`` is given). On the ``meta`` device
    nothing is drawn or allocated. With ``index`` (one step-1 slice per
    dim, or a list of such boxes joined on the last dim: ``take_box``)
    only that part of the tensor is returned: the generator advances as
    for the whole draw and the part holds the whole draw's values, and a
    tensor drawn piece by piece is never whole in memory (a rank's shard
    of an expert stack plus one piece)."""
    if device is not None and torch.device(device).type == "meta":
        whole = torch.empty(tuple(shape), dtype=dtype, device="meta")
        return whole if index is None else take_box(whole, index)
    fan_in = 1
    for ax in range(len(shape) - 1) if in_axis is None else [in_axis]:
        fan_in *= shape[ax]
    device = gen.device if device is None else device
    n = math.prod(shape)
    if dtype == torch.float32 or n <= DRAW:
        out = (torch.randn(tuple(shape), generator=gen, device=device)
               * fan_in ** -0.5).to(dtype)
        return out if index is None else take_box(out, index).clone()
    boxes = [_Box(shape, b) for b in (index if isinstance(index, list)
                                      else [index])]
    width = sum(b.hi - b.lo for b in boxes)
    out = torch.empty((*boxes[0].shape[:-1], width) if len(boxes) > 1
                      else boxes[0].shape, dtype=dtype, device=device)
    rows2d = out.view(-1, width)
    cols, at = [], 0
    for b in boxes:              # each box's columns of the joined rows
        if len(boxes) > 1 and b.row != shape[-1]:
            raise ValueError("dense_init: boxes joined on the last dim must "
                             "cut no other dim")
        cols.append(rows2d[:, at:at + b.hi - b.lo])
        at += b.hi - b.lo
    for i in range(0, n, DRAW):
        m = min(DRAW, n - i)
        piece = (torch.randn(m, generator=gen, device=device)
                 * fan_in ** -0.5).to(dtype)
        for b, dest in zip(boxes, cols):
            b.take(dest, piece, i)
    return out


class _Box:
    """A box (one step-1 slice per dim) of a C-contiguous tensor of
    ``shape``, seen as rows: the flat tensor is [outer, row] with ``row``
    the elements from the box's last cut dim ``j`` on, and the box takes
    columns [lo, hi) of the rows whose multi-index over the dims before
    ``j`` lies in its slices. ``take`` copies the part of a flat piece of
    the tensor that falls in the box into the box's own rows."""

    def __init__(self, shape: Sequence[int], index: Optional[tuple]):
        shape = tuple(shape)
        spans = [(0, n) if index is None else index[d].indices(n)[:2]
                 for d, n in enumerate(shape)]
        self.shape = tuple(b - a for a, b in spans)
        cut = [d for d, (a, b) in enumerate(spans) if (a, b) != (0, shape[d])]
        j = cut[-1] if cut else 0
        inner = math.prod(shape[j + 1:])
        self.row = shape[j] * inner
        self.lo, self.hi = spans[j][0] * inner, spans[j][1] * inner
        self.outer = list(zip(shape[:j], spans[:j]))
        self.whole_rows = all((a, b) == (0, n) for n, (a, b) in self.outer)

    def _dest(self, rows: torch.Tensor):
        """(in the box, the box's row) of full-tensor rows ``rows``."""
        ok = torch.ones_like(rows, dtype=torch.bool)
        dest = torch.zeros_like(rows)
        rem, coords = rows, []
        for n, _ in reversed(self.outer):
            coords.append(rem % n)
            rem = rem // n
        for c, (n, (a, b)) in zip(reversed(coords), self.outer):
            ok &= (c >= a) & (c < b)
            dest = dest * (b - a) + (c - a)
        return ok, dest

    def take(self, rows2d: torch.Tensor, vals: torch.Tensor,
             start: int) -> None:
        """``rows2d``: the box's tensor as [box rows, hi - lo] (a view)."""
        row, lo, hi = self.row, self.lo, self.hi
        end = start + vals.numel()
        fa, fb = -(-start // row), end // row        # rows wholly inside
        if fa < fb:
            block = vals[fa * row - start:fb * row - start].view(
                fb - fa, row)[:, lo:hi]
            if self.whole_rows:
                rows2d[fa:fb] = block
            else:
                ok, dest = self._dest(torch.arange(fa, fb,
                                                   device=vals.device))
                rows2d[dest[ok]] = block[ok]
        for r in sorted({start // row, (end - 1) // row}):
            if fa <= r < fb:
                continue
            a = max(lo, start - r * row)
            b = min(hi, end - r * row)
            if a >= b:
                continue
            ok, dest = self._dest(torch.tensor([r], device=vals.device))
            if bool(ok[0]):
                rows2d[int(dest[0]), a - lo:b - lo] = \
                    vals[r * row + a - start:r * row + b - start]


def stacked_dense_init(gen: torch.Generator, n: int, shape: Sequence[int],
                       in_axis: int = 0, dtype=torch.float32,
                       device=None, index=None) -> torch.Tensor:
    """[n, *shape]: one independent init per layer (``in_axis`` indexes
    ``shape``); ``index`` as in :func:`dense_init`."""
    return dense_init(gen, (n, *shape), in_axis + 1, dtype, device, index)
