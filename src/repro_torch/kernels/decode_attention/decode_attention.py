"""Wrapper of the hand-written Hopper decode attention
(``csrc/decode_attention.cu``).

The port of the JAX package's Pallas kernel ``decode_attention``
(``src/repro/kernels/decode_attention/decode_attention.py``): one new token
per sequence attends to its KV cache, GQA, with a ragged ``kv_len``. The
CUDA code is split-S flash-decoding: a first kernel writes one f32 partial
(max, sum, unnormalised output) per (batch, q head, cache range), a second
merges them. Two partials kernels:

- bf16 whose K and V rows the tensor-core kernel can read (unit d-stride,
  D % 16 == 0, 16-byte aligned rows and base): a ring of K/V tiles filled by
  ``cp.async``, Q·Kᵀ and P·V on ``mma.sync`` (``ring``);
- everything else, f32 always: IEEE f32 on the CUDA cores, the cache read
  through its own strides (16 bytes at a time where the layout allows). A
  bf16 call that lands here is counted in ``decode_attention.narrow``.

Every S >= 1 and D <= 128 works. See the note at the top of the source for
what bounds it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from .ref import decode_ref

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}   # entry suffixes
TS = 64                  # cache positions per tile, CUDA-core kernel
GMAX = 8                 # q heads per block, CUDA-core kernel
RING_ROWS = 16           # q heads per block, tensor-core kernel (mma's M)
MAX_D = 128
_INT_MAX = 2 ** 31 - 1


@functools.cache
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, with its argument types declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = getattr(_build.load("decode_attention"),
                 f"decode_attention_{_DTYPES[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _ring_entry():
    """The tensor-core kernel's C entry point (bf16 only, no ``vec``)."""
    fn = _build.load("decode_attention").decode_attention_bf16_ring
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def uses_ring(dtype: torch.dtype, d: int, vec: bool) -> bool:
    """Whether a call launches the tensor-core kernel: bf16, rows read 16
    bytes at a time, whole k16 steps of D."""
    return dtype == torch.bfloat16 and vec and d % 16 == 0


class KernelInfo(NamedTuple):
    """What the CUDA runtime and the source report of one instantiation of
    the partials kernel."""
    blocks_per_sm: int
    registers: int
    spill_bytes: int
    smem_bytes: int
    ts: int          # cache positions per tile
    stages: int      # tiles held at once (the ring's depth)


@functools.cache
def kernel_info(dtype: torch.dtype, d: int, vec: bool,
                index: int) -> KernelInfo:
    """The partials kernel that ``decode_attention`` launches for ``dtype``,
    head dim ``d`` and 16-byte loads or not, on CUDA device ``index``:
    resident blocks per SM, registers and spill bytes per thread (CUDA
    runtime), its shared memory, tile and stages (the source)."""
    info = (ctypes.c_int * 6)()
    lib = _build.load("decode_attention")
    if uses_ring(dtype, d, vec):
        fn, args = lib.decode_attention_info_bf16_ring, (d,)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    else:
        fn = getattr(lib, f"decode_attention_info_{_DTYPES[dtype]}")
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        args = (d, int(vec))
    with torch.cuda.device(index):
        err = fn(*args, info)
    if err != 0 or info[0] < 1:
        raise RuntimeError(f"decode_attention: no resident block for "
                           f"{dtype}, D={d} (CUDA error {err})")
    return KernelInfo(*info)


@functools.cache
def _slots(dtype: torch.dtype, d: int, vec: bool, index: int) -> int:
    """Blocks of the first kernel resident on the whole card at once."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * kernel_info(dtype, d, vec, index).blocks_per_sm


def split_plan(s: int, rows: int, slots: int,
               ts: int = TS) -> Tuple[int, int]:
    """(chunk, n_split): the cache ranges of the first kernel, chosen on the
    host from S and the number of (batch, KV head, group slice) rows so that
    the grid is at most one wave of the card's ``slots`` resident blocks
    (unless the rows alone exceed it). ``chunk`` is a multiple of the
    kernel's tile of ``ts`` positions, and the ``n_split`` ranges of
    ``chunk`` positions cover S with none empty."""
    tiles = -(-s // ts)
    want = min(tiles, max(1, slots // rows))
    per = -(-tiles // want)          # tiles per range
    return per * ts, -(-tiles // per)


def _vec_ok(t: torch.Tensor, n: int) -> bool:
    """Whether the kernel may read ``t``'s rows 16 bytes at a time."""
    size = t.element_size()
    return (t.stride(3) == 1 and t.shape[3] % n == 0
            and t.data_ptr() % 16 == 0
            and all(t.stride(i) * size % 16 == 0 for i in range(3)))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B, Hq, D]; k/v: [B, Hkv, S, D], Hq % Hkv == 0; kv_len: integer
    [B] or None (all S) -> [B, Hq, D] in q's dtype, f32 or bf16, any
    strides. Positions at or past kv_len[b] (clamped to S) are dead;
    kv_len >= 1 is a precondition (0 gives NaN, as ``decode_ref`` does).

    On CPU tensors this is the plain version (``ref.decode_ref``); on CUDA
    tensors it launches the kernel pair (partials, then their merge) on the
    current stream, or raises. ``decode_attention.launches`` counts the
    calls that launch, one per call (each call is the two launches);
    ``decode_attention.narrow`` the bf16 ones whose layout sends them to
    the CUDA-core kernel."""
    operands = (q, k, v) + (() if kv_len is None else (kv_len,))
    if all(t.device.type == "cpu" for t in operands):
        return decode_ref(q, k, v, kv_len)
    if q.device.type != "cuda" or any(t.device != q.device for t in operands):
        raise ValueError("decode_attention: operands on "
                         f"{[str(t.device) for t in operands]}; all must be "
                         "on one CUDA device (or all on CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 "
                        f"operands of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention takes q [B,Hq,D] and k, v "
                         f"[B,Hkv,S,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not pair (Hq % Hkv == 0)")
    if not 1 <= d <= MAX_D or s == 0:
        raise ValueError(f"decode_attention: head dim {d} not in [1, "
                         f"{MAX_D}], or an empty cache (S = {s})")
    if max(b * hq, s) > _INT_MAX:
        raise ValueError("decode_attention: a dimension exceeds 2**31 - 1")
    if kv_len is not None:
        if kv_len.shape != (b,) or kv_len.is_floating_point():
            raise ValueError(f"decode_attention: kv_len must be integer [B] "
                             f"= [{b}], got {kv_len.dtype} "
                             f"{tuple(kv_len.shape)}")
        kv_len = kv_len.to(torch.int32).contiguous()
    _build.refuse_grad("decode_attention", q, k, v)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    group = hq // hkv
    vec = _vec_ok(k, 16 // q.element_size()) and _vec_ok(
        v, 16 // q.element_size())
    ring = uses_ring(q.dtype, d, vec)
    rows = b * hkv * -(-group // (RING_ROWS if ring else GMAX))
    index = q.device.index or 0
    chunk, n_split = split_plan(s, rows, _slots(q.dtype, d, vec, index),
                                kernel_info(q.dtype, d, vec, index).ts)
    ws = torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                     device=q.device)
    ws_ml = ws[b * hq * n_split * d:]
    strides = (ctypes.c_longlong * 11)(*q.stride(), *k.stride(), *v.stride())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if kv_len is None else kv_len.data_ptr(), ws.data_ptr(),
                ws_ml.data_ptr(), out.data_ptr(), b, hq, hkv, s, d, chunk,
                n_split)
        if ring:
            err = _ring_entry()(*ptrs, d ** -0.5, strides, stream)
        else:
            err = _entry(q.dtype)(*ptrs, int(vec), d ** -0.5, strides,
                                  stream)
    decode_attention.launches += 1
    decode_attention.narrow += q.dtype == torch.bfloat16 and not ring
    if err != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with "
                           f"CUDA error {err}")
    return out


decode_attention.launches = 0
decode_attention.narrow = 0
