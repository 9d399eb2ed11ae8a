"""Wrapper of the hand-written Hopper flash attention
(``csrc/flash_attention.cu``).

The port of the JAX package's Pallas kernel ``flash_attention``
(``src/repro/kernels/flash_attention/flash_attention.py``): causal or full
GQA attention, forward, with the softmax in f32, and with an optional
sliding window (keys ``window`` or more positions before their query are
masked, as the JAX package's ``chunked_attention`` masks them; its Pallas
kernel has no window). Two designs in one source:

- bf16: both products on the tensor cores (``wgmma``), K and V brought in
  by TMA. TMA reads only rows with unit column stride, 16-byte multiples
  for every other stride and a 16-byte-aligned base; an operand laid out
  otherwise is copied into such a layout first (``needs_copy``; counted in
  ``flash_attention.copies``), never routed elsewhere.
- f32: IEEE f32 on the CUDA cores. Each query tile's KV walk is cut into
  ranges (``split_plan``) so that one (batch, head) fills the card; the
  ranges' f32 partials are merged by a second kernel. The plan depends on
  the call's own (Lq, Lk, D, causal, window) and the card only, never on
  the batch, so a task's result does not depend on the batch it rides in.

Every L and every D <= 128 works, through the operands' own strides. See the
note at the top of the source for what bounds each path.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

from .. import _build
from .ref import mha_ref

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_D = 128
_INT_MAX = 2 ** 31 - 1
# C error codes beside the CUDA runtime's (``ERR_*`` in the source)
_ERRORS = {20000: "cuTensorMapEncodeTiled is not reachable through the CUDA "
                  "runtime (driver too old)",
           20001: "the bf16 kernel was compiled with fewer registers than "
                  "its setmaxnreg budget needs"}


def _error(err: int) -> str:
    if err in _ERRORS:
        return _ERRORS[err]
    if 10000 <= err < 20000:
        return f"cuTensorMapEncodeTiled failed with CUresult {err - 10000}"
    return f"CUDA error {err}"


class KernelInfo(NamedTuple):
    """What the CUDA runtime and the source report of one instantiation."""
    blocks_per_sm: int
    registers: int
    spill_bytes: int
    smem_bytes: int
    bq: int          # queries per block
    bk: int          # keys per KV tile


@functools.cache
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, with its argument types declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = getattr(_build.load("flash_attention"),
                 f"flash_attention_{_SUFFIX[dtype]}")
    ints, strides = ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    if dtype == torch.bfloat16:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ints] * 8
                       + [ctypes.c_float, strides, ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ints] * 11
                       + [ctypes.c_float, strides, ints, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def kernel_info(dtype: torch.dtype, d: int, index: int = 0) -> KernelInfo:
    """The instantiation that ``flash_attention`` launches for ``dtype`` at
    head dim ``d`` on CUDA device ``index`` (f32: with 16-byte loads):
    resident blocks per SM, registers and spill bytes per thread (CUDA
    runtime), its shared memory and tiles (the source)."""
    info = (ctypes.c_int * 6)()
    lib = _build.load("flash_attention")
    fn = getattr(lib, f"flash_attention_info_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    with torch.cuda.device(index):
        err = fn(d, info)
    if err != 0 or info[0] < 1:
        raise RuntimeError(f"flash_attention: no resident block for {dtype}, "
                           f"D={d}: {_error(err)}")
    return KernelInfo(*info)


class SplitPlan(NamedTuple):
    """The f32 kernel's work items: ``items[i] = (query tile, first KV
    tile, end KV tile)``, the ranges of one query tile consecutive, longest
    walks first; ``tiles[t] = (first item, number of items)`` of query tile
    ``t``; ``per``: the most KV tiles in one range."""
    per: int
    items: Tuple[Tuple[int, int, int], ...]
    tiles: Tuple[Tuple[int, int], ...]


@functools.cache
def split_plan(lq: int, lk: int, causal: bool, bq: int, bk: int,
               slots: int, window: int = 0) -> SplitPlan:
    """Cut each query tile's KV walk into ranges of at most ``per`` tiles,
    ``per`` the smallest that keeps the ranges of one (batch, head) within
    ``slots`` (the card's resident blocks: one wave). Query tile ``t``
    covers rows [t·bq, (t+1)·bq) at positions Lk - Lq + row and walks the
    tiles of keys below its causal bound (all Lk keys when not causal),
    from the first tile its first row's ``window`` reaches (tile 0 without
    a window); its ranges split that walk into near-equal parts. A function
    of the call's own shape and the card only: the batch does not enter
    it."""
    n_qt = -(-lq // bq)
    begin, walk = [], []
    for t in range(n_qt):
        end = lk
        if causal:
            end = max(0, min(lk, min(lq, (t + 1) * bq) + lk - lq))
        end = -(-end // bk)
        first = 0
        if window:
            first = min(end, max(0, t * bq + lk - lq - window + 1) // bk)
        begin.append(first)
        walk.append(end - first)

    def n_items(per):
        return sum(max(1, -(-n // per)) for n in walk)

    lo, hi = 1, max(1, max(walk))
    while lo < hi:                      # n_items falls as per grows
        mid = (lo + hi) // 2
        if n_items(mid) <= slots:
            hi = mid
        else:
            lo = mid + 1
    items: List[Tuple[int, int, int]] = []
    tiles = [(0, 0)] * n_qt
    for t in reversed(range(n_qt)):
        n = walk[t]
        parts = max(1, -(-n // lo))
        tiles[t] = (len(items), parts)
        items += [(t, begin[t] + p * n // parts,
                   begin[t] + (p + 1) * n // parts) for p in range(parts)]
    return SplitPlan(lo, tuple(items), tuple(tiles))


def plan_for(q_shape: Sequence[int], k_shape: Sequence[int], causal: bool,
             info: KernelInfo, sms: int, window: int = 0) -> SplitPlan:
    """The split plan of an f32 call with q ``q_shape`` [B, Hq, Lq, D] and
    k ``k_shape`` on a card of ``sms`` SMs: only Lq, Lk and the window
    enter, with the instantiation's tiles and resident blocks (``info``,
    from D)."""
    return split_plan(q_shape[2], k_shape[2], bool(causal), info.bq, info.bk,
                      sms * info.blocks_per_sm, window)


@functools.lru_cache(maxsize=256)
def _f32_launch(q_shape: torch.Size, k_shape: torch.Size, causal: bool,
                window: int, index: int):
    """What an f32 call of these shapes on CUDA device ``index`` hands the
    kernel, worked out once: (the plan as the kernel reads it, int32 items
    then query tiles, on the device; number of items; number of query
    tiles; the most ranges of one query tile; rows of one item)."""
    info = kernel_info(torch.float32, q_shape[3], index)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    plan = plan_for(q_shape, k_shape, causal, info, sms, window)
    flat = [x for item in plan.items for x in item]
    flat += [x for tile in plan.tiles for x in tile]
    return (torch.tensor(flat, dtype=torch.int32,
                         device=torch.device("cuda", index)),
            len(plan.items), len(plan.tiles),
            max(count for _, count in plan.tiles), info.bq)


def needs_copy(shape: Sequence[int], strides: Sequence[int], itemsize: int,
               address: int) -> bool:
    """Whether TMA cannot read a [B, H, L, D] operand as it lies: it needs
    a unit stride along D (when D > 1), the stride of every other dimension
    longer than 1 a multiple of 16 bytes, and a 16-byte-aligned base."""
    if address % 16 or (shape[3] > 1 and strides[3] != 1):
        return True
    return any(n > 1 and (s * itemsize) % 16
               for n, s in zip(shape[:3], strides[:3]))


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy TMA can read (rows padded to 16 bytes),
    counted in ``flash_attention.copies``."""
    if not needs_copy(t.shape, t.stride(), t.element_size(), t.data_ptr()):
        return t
    d = t.shape[3]
    buf = torch.empty((*t.shape[:3], -(-d // 8) * 8), dtype=t.dtype,
                      device=t.device)
    buf[..., :d].copy_(t)
    flash_attention.copies += 1
    return buf[..., :d]


def _vec_ok(t: torch.Tensor) -> bool:
    """Whether the f32 kernel may copy ``t``'s rows 16 bytes at a time."""
    sb, sh, sl, sd = t.stride()
    b, h, l, d = t.shape
    return (d % 4 == 0 and sd == 1 and t.data_ptr() % 16 == 0
            and (b == 1 or sb % 4 == 0) and (h == 1 or sh % 4 == 0)
            and (l == 1 or sl % 4 == 0))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, Hq, Lq, D]; k/v: [B, Hkv, Lk, D] -> [B, Hq, Lq, D] in q's
    dtype, f32 or bf16, any strides. Query i sits at position Lk - Lq + i;
    ``causal`` masks the keys after it, a ``window`` > 0 the keys ``window``
    or more positions before it (a window of Lk or more masks none).

    On CPU tensors this is the plain version (``ref.mha_ref``); on CUDA
    tensors it launches the kernel, on the current stream, or raises.
    ``flash_attention.launches`` counts the calls that launch (an f32 call
    with split ranges is two launches: partials, then their merge);
    ``flash_attention.copies`` counts bf16 operands copied for TMA."""
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return mha_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: operands on {q.device}, "
                         f"{k.device}, {v.device}; all must be on one CUDA "
                         "device (or all on CPU)")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
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
    window = 0 if window >= lk else int(window)     # masks no key
    _build.refuse_grad("flash_attention", q, k, v)
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    index = q.device.index
    guard = (contextlib.nullcontext() if torch.cuda.current_device() == index
             else torch.cuda.device(index))
    with guard:     # the kernels launch on the current device's stream
        stream = torch._C._cuda_getCurrentRawStream(index)
        if q.dtype == torch.bfloat16:
            q, k, v = (_tma_operand(t) for t in (q, k, v))
        strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(),
                                           *v.stride())
        if q.dtype == torch.bfloat16:
            err = _entry(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), b, hq, hkv, lq, lk, d,
                                  int(causal), window, d ** -0.5, strides,
                                  stream)
        else:
            plan, n_items, n_qt, max_count, bq = _f32_launch(
                q.shape, k.shape, bool(causal), window, index)
            rows = b * hq * n_items * bq if max_count > 1 else 0
            dpad = -(-d // 4) * 4
            ws = torch.empty(rows * (dpad + 2) or 1, dtype=torch.float32,
                             device=q.device)
            err = _entry(q.dtype)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ws.data_ptr(), ws.data_ptr() + 4 * rows * dpad,
                plan.data_ptr(), n_items, n_qt, max_count, b, hq, hkv, lq,
                lk, d, int(causal), window, d ** -0.5, strides,
                int(_vec_ok(q) and _vec_ok(k) and _vec_ok(v)), stream)
    flash_attention.launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed: "
                           f"{_error(err)}")
    return out


flash_attention.launches = 0
flash_attention.copies = 0
