"""Wrapper of the hand-written Hopper flash attention
(``csrc/flash_attention.cu``).

The port of the JAX package's Pallas kernel ``flash_attention``
(``src/repro/kernels/flash_attention/flash_attention.py``): causal or full
GQA attention, forward, with the softmax in f32. The CUDA kernel reads q, k
and v through their own strides, masks ragged edges (every L and every
D <= 128 works) and stops each query tile's KV walk at its causal bound.
See the note at the top of the source for what bounds it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import mha_ref

_DTYPES = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
_BQ = _BK = 64           # the kernel's query and key tiles
MAX_D = 128
_INT_MAX = 2 ** 31 - 1


@functools.cache
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, with its argument types declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = getattr(_build.load("flash_attention"), _DTYPES[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block: the Q tile and the K/V tile, rows
    padded to d + 1 floats, and the probabilities, [64][65] floats."""
    return 4 * ((_BQ + _BK) * (d + 1) + _BQ * (_BK + 1))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, Hq, Lq, D]; k/v: [B, Hkv, Lk, D] -> [B, Hq, Lq, D] in q's
    dtype, f32 or bf16, any strides.

    On CPU tensors this is the plain version (``ref.mha_ref``); on CUDA
    tensors it launches the kernel, on the current stream, or raises.
    ``flash_attention.launches`` counts the launches."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return mha_ref(q, k, v, causal=causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: operands on {q.device}, "
                         f"{k.device}, {v.device}; all must be on one CUDA "
                         "device (or all on CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 operands "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q [B,Hq,Lq,D] and k, v "
                         f"[B,Hkv,Lk,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not pair (Hq % Hkv == 0)")
    if d > MAX_D:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_D}")
    if max(b * hq, lq, lk) > _INT_MAX:
        raise ValueError("flash_attention: a dimension exceeds 2**31 - 1")
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), b, hq, hkv, lq, lk, d,
                              int(causal), d ** -0.5, strides, smem_bytes(d),
                              stream)
    flash_attention.launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    return out


flash_attention.launches = 0
