"""Batched block GEMM: the body of the GEMM update and of Cholesky's
trailing updates (the port of the JAX package's Pallas ``block_gemm``)."""

from .block_gemm import block_gemm
from .ops import matmul, task_matmul
from .ref import block_gemm_ref

__all__ = ["block_gemm", "block_gemm_ref", "matmul", "task_matmul"]
