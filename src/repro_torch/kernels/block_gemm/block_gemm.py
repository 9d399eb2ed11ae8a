"""Wrapper of the hand-written Hopper block GEMM (``csrc/block_gemm.cu``).

The port of the JAX package's Pallas kernel ``block_gemm``
(``src/repro/kernels/block_gemm/block_gemm.py``): ``C[t] = A[t] @ B[t]``
with f32 accumulation, written in A's dtype. The CUDA kernel takes A and B
through their own strides, masks ragged edges (every M, N, K works) and
covers the whole batch in one launch. f32 runs a pipelined SGEMM whose
shared tiles keep each operand's contiguous dimension: the source picks one
of four instantiations (A k- or m-contiguous, B n- or k-contiguous) from the
strides. See the note at the top of the source for what bounds it and how it
is built.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from .. import _build
from .ref import block_gemm_ref

_DTYPES = {torch.float32: "block_gemm_f32", torch.bfloat16: "block_gemm_bf16"}
_INT_MAX = 2 ** 31 - 1
_COUNT = threading.Lock()


@functools.cache
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, with its argument types declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = getattr(_build.load("block_gemm"), _DTYPES[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class KernelInfo(NamedTuple):
    """What the CUDA runtime and the source report of one f32
    instantiation."""
    blocks_per_sm: int
    registers: int
    spill_bytes: int
    smem_bytes: int
    bk: int          # depth of one K step
    stages: int      # K steps in the shared ring


@functools.cache
def kernel_info(a_k: bool, b_n: bool, index: int = 0) -> KernelInfo:
    """The f32 instantiation for A k-contiguous (else m-contiguous) and B
    n-contiguous (else k-contiguous) on CUDA device ``index``: resident
    blocks per SM, registers and spill bytes per thread (CUDA runtime), its
    shared memory, BK and stages (the source). Cholesky's ``l @ l.mT`` runs
    (True, False), the row-major GEMM update (True, True)."""
    info = (ctypes.c_int * 6)()
    fn = _build.load("block_gemm").block_gemm_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    with torch.cuda.device(index):
        err = fn(int(a_k), int(b_n), info)
    if err != 0 or info[0] < 1:
        raise RuntimeError(f"block_gemm: no resident block for a_k={a_k}, "
                           f"b_n={b_n} (CUDA error {err})")
    return KernelInfo(*info)


def block_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` for ``A [T, M, K]``, ``B [T, K, N]`` (or unbatched
    ``[M, K]`` x ``[K, N]``), f32 or bf16, any strides.

    On CPU tensors this is the plain version (``ref.block_gemm_ref``); on
    CUDA tensors it launches the kernel, on the current stream, or raises.
    ``block_gemm.launches`` counts the launches, under a lock: the host
    runtime's worker threads launch it together."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return block_gemm_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"block_gemm: operands on {a.device} and {b.device}; "
                         "both must be on one CUDA device (or both on CPU)")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"block_gemm takes float32 or bfloat16 operands of "
                        f"one dtype, got {a.dtype} and {b.dtype}")
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"block_gemm takes [T,M,K] x [T,K,N] or [M,K] x "
                         f"[K,N], got {tuple(a.shape)} x {tuple(b.shape)}")
    unbatched = a.dim() == 2
    if unbatched:
        a, b = a.unsqueeze(0), b.unsqueeze(0)
    T, M, K = a.shape
    if b.shape[0] != T or b.shape[1] != K:
        raise ValueError(f"block_gemm: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not chain")
    N = b.shape[2]
    if max(T, M, N, K) > _INT_MAX:
        raise ValueError("block_gemm: a dimension exceeds 2**31 - 1")
    _build.refuse_grad("block_gemm", a, b)
    c = torch.empty((T, M, N), dtype=a.dtype, device=a.device)
    if T and M and N:
        fn = _entry(a.dtype)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), T, M, N, K,
                     *a.stride(), *b.stride(), stream)
        with _COUNT:
            block_gemm.launches += 1
        if err != 0:
            raise RuntimeError(f"block_gemm: kernel launch failed with CUDA "
                               f"error {err}")
    return c[0] if unbatched else c


block_gemm.launches = 0
