"""Plain PyTorch version of the block GEMM kernel."""

import torch


def block_gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with f32 accumulation; result in A's dtype. Batched over
    leading dimensions like ``torch.matmul``. On the card, f32 stays IEEE f32
    only while ``torch.backends.cuda.matmul.allow_tf32`` is False (its
    default)."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)
