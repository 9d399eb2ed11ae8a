"""Forms of the flash attention kernel: the 4-D ``attention`` and the block
executor's batched body ``task_attention``.

Unlike the JAX package's ``attention``, neither falls back to the plain
version for shapes that do not tile: the CUDA kernel masks ragged edges.
On CPU tensors both are the plain version.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal (or full) GQA attention, q [B, Hq, Lq, D], k/v [B, Hkv, Lk,
    D] -> [B, Hq, Lq, D], with an optional sliding ``window``."""
    return flash_attention(q, k, v, causal=causal, window=window)


def task_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True) -> torch.Tensor:
    """The executor's batched body form: single-head attention over ``[T,
    L, D]`` blocks, one task per leading index. One kernel launch covers
    every task of a wavefront's batch of one type (the counterpart of
    ``vmap(pallas_call)`` in the JAX package): the batch is read as B = T
    with H = 1, through views, with no copy of the operands."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"task_attention takes batched [T, L, D] blocks, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return flash_attention(q[:, None], k[:, None], v[:, None],
                           causal=causal)[:, 0]
