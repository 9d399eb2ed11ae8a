"""Body forms of the block GEMM kernel for the block executor.

Unlike the JAX package's ``matmul``, neither falls back to the plain version
for shapes that do not tile: the CUDA kernel masks ragged edges and takes
every shape. On CPU tensors both are the plain version.
"""

from __future__ import annotations

import torch

from .block_gemm import block_gemm


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Drop-in ``a @ b`` for one pair of blocks, ``[M, K] x [K, N]``."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D blocks, got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    return block_gemm(a, b)


def task_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The executor's batched body form, ``[T, M, K] x [T, K, N]``: one
    kernel launch covers every task of a wavefront's batch of one type
    (the counterpart of ``vmap(pallas_call)`` in the JAX package). Pass it as
    ``gemm_bodies(matmul=task_matmul)`` / ``cholesky_bodies(matmul=
    task_matmul)``; operands may be transposed views (``l.mT``)."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"task_matmul takes batched [T, M, K] x [T, K, N] "
                         f"blocks, got {tuple(a.shape)} x {tuple(b.shape)}")
    return block_gemm(a, b)
