"""Wrapper of the hand-written Hopper SSD scan (``csrc/ssd_scan.cu``).

The port of the JAX package's Pallas kernel ``ssd_scan``
(``src/repro/kernels/ssd_scan/ssd_scan.py``): the Mamba-2 SSD by chunks,
with the D skip added in the same pass. On the card it is chunk-parallel:
four kernels (cumsum; C Bᵀ per group; the states entering each chunk, the
chunks walked in order with the state in registers; the output), bf16
products on the tensor cores. Every kernel walks 64-wide tiles, so any
chunk length Q >= 1 and any L work (a ragged last chunk is masked). x, dt,
B and C are read through their own strides; the rows of x, B and C are
copied 16 bytes at a time where their layout allows it, else element by
element, counted in ``ssd_scan.narrow``. The wrapper allocates the
scratch the kernels share (``plan``). See the note at the top of the
source for what bounds it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from .ref import ssd_chunked_ref, ssd_ref

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}   # entry suffixes
TILE = 64                 # rows and columns of every tile of the kernels
KERNELS = ("ssd_cumsum", "ssd_cb", "ssd_state", "ssd_out")
_ALIGN = 256              # bytes between the scratch's pieces
_INT_MAX = 2 ** 31 - 1


class Plan(NamedTuple):
    """How one call is cut: the chunk ``q``, its rows padded to whole tiles
    (``qp``), the chunks ``nc``, N and P padded to whole tiles, the kernels
    it launches, and the byte offsets of the scratch's pieces (dt and cum
    [B·H][nc][qp] f32, C Bᵀ [B·G][nc][qp][qp] f32 and the states entering
    chunks 1 .. nc-1, [B·H][nc-1][npd][ppd] in x's type) within
    ``nbytes``."""
    q: int
    qp: int
    nc: int
    npd: int
    ppd: int
    kernels: int
    offsets: Tuple[int, int, int, int]   # dtc, cum, cb, h
    nbytes: int


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def plan(bsz: int, l: int, h: int, g: int, p: int, n: int, q_chunk: int,
         itemsize: int) -> Plan:
    """The cut of a call with x [bsz, l, h, p], B/C [bsz, l, g, n] and
    chunk ``min(q_chunk, l)``, x's elements ``itemsize`` bytes wide."""
    q = min(q_chunk, l)
    if q < 1:
        raise ValueError(f"ssd_scan: chunk {q_chunk} < 1")
    qp, npd, ppd = _up(q, TILE), _up(n, TILE), _up(p, TILE)
    nc = -(-l // q)
    sizes = (4 * bsz * h * nc * qp, 4 * bsz * h * nc * qp,
             4 * bsz * g * nc * qp * qp,
             itemsize * bsz * h * (nc - 1) * npd * ppd)
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at)
        at += _up(size, _ALIGN)
    return Plan(q, qp, nc, npd, ppd, 4 if nc > 1 else 3, tuple(offsets), at)


def vec_ok(t: torch.Tensor) -> bool:
    """Whether the kernels may copy ``t``'s rows (its last dimension) 16
    bytes at a time: unit stride there, whole 16-byte pieces, 16-byte
    aligned base and strides (of the dimensions longer than one)."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.shape[-1] * size % 16 == 0
            and t.data_ptr() % 16 == 0
            and all(k == 1 or s * size % 16 == 0
                    for k, s in zip(t.shape[:-1], t.stride()[:-1])))


@functools.cache
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``: pointers and dims as arrays, the
    stream as ``c_void_p``."""
    fn = getattr(_build.load("ssd_scan"), f"ssd_scan_{_DTYPES[dtype]}")
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class KernelInfo(NamedTuple):
    """What the CUDA runtime reports of one kernel."""
    registers: int
    spill_bytes: int
    blocks_per_sm: int
    smem_bytes: int


@functools.cache
def kernel_info(dtype: torch.dtype, index: int) -> dict:
    """{kernel name: KernelInfo} of ``dtype``'s four kernels on CUDA device
    ``index``."""
    fn = getattr(_build.load("ssd_scan"), f"ssd_scan_info_{_DTYPES[dtype]}")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 16)()
    with torch.cuda.device(index):
        err = fn(out)
    if err != 0:
        raise RuntimeError(f"ssd_scan: kernel_info failed with CUDA error "
                           f"{err}")
    return {name: KernelInfo(*out[4 * k:4 * k + 4])
            for k, name in enumerate(KERNELS)}


def plain(x, dt, a, b, c, d, q_chunk):
    """The JAX package's off-TPU rule (``ops.py:15-20``): the chunked
    algorithm when L tiles, else the token recurrence."""
    if x.shape[1] % min(q_chunk, x.shape[1]) == 0:
        return ssd_chunked_ref(x, dt, a, b, c, d, q_chunk=q_chunk)
    return ssd_ref(x, dt, a, b, c, d)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: Optional[torch.Tensor] = None,
             *, q_chunk: int = 128) -> torch.Tensor:
    """x: [B, L, H, P]; dt: [B, L, H]; a: [H]; b/c: [B, L, G, N]; d: [H] or
    None -> y [B, L, H, P] in x's dtype. x, dt, b and c share one dtype,
    f32 or bf16, with any strides; a and d are read as f32.

    On CPU tensors this is the plain version (the chunked algorithm when L
    tiles by ``min(q_chunk, L)``, else the token recurrence); on CUDA
    tensors it launches the kernels, on the current stream, or raises.
    ``ssd_scan.launches`` counts the calls that launch (each call is
    ``plan(...).kernels`` launches); ``ssd_scan.narrow`` the calls in which
    x, B or C is copied element by element."""
    ops = (x, dt, a, b, c) + ((d,) if d is not None else ())
    if all(t.device.type == "cpu" for t in ops):
        return plain(x, dt, a, b, c, d, q_chunk)
    if x.device.type != "cuda" or any(t.device != x.device for t in ops):
        raise ValueError("ssd_scan: operands must all be on one CUDA device "
                         "(or all on CPU)")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, b, c)):
        raise TypeError(f"ssd_scan takes x, dt, b, c of one dtype, float32 or "
                        f"bfloat16, got {x.dtype}, {dt.dtype}, {b.dtype}, "
                        f"{c.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError("ssd_scan takes x [B,L,H,P], dt [B,L,H], b/c "
                         "[B,L,G,N]")
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (tuple(dt.shape) != (bsz, l, h) or tuple(b.shape[:2]) != (bsz, l)
            or g == 0 or h % g or a.shape != (h,)
            or (d is not None and d.shape != (h,))):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not pair (H % G == 0)")
    _build.refuse_grad("ssd_scan", *ops)
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    pl = plan(bsz, l, h, g, p, n, q_chunk, x.element_size())
    if max(bsz * l * h * p, pl.nc * pl.qp) > _INT_MAX:
        raise ValueError("ssd_scan: a dimension exceeds 2**31 - 1")
    vec = (vec_ok(x), vec_ok(b), vec_ok(c))
    a32 = a.to(torch.float32).contiguous()
    d32 = d.to(torch.float32).contiguous() if d is not None else None
    scratch = torch.empty(pl.nbytes, dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    ptrs = (ctypes.c_void_p * 11)(
        x.data_ptr(), dt.data_ptr(), a32.data_ptr(), b.data_ptr(),
        c.data_ptr(), None if d32 is None else d32.data_ptr(), y.data_ptr(),
        *(base + off for off in pl.offsets))
    args = (ctypes.c_longlong * 29)(
        bsz, l, h, g, p, n, pl.q, pl.qp, pl.nc, pl.npd, pl.ppd, *vec,
        *x.stride(), *dt.stride(), *b.stride(), *c.stride())
    index = x.device.index
    guard = (contextlib.nullcontext() if torch.cuda.current_device() == index
             else torch.cuda.device(index))
    with guard:     # the kernels launch on the current device's stream
        err = _entry(x.dtype)(ptrs, args,
                              torch._C._cuda_getCurrentRawStream(index))
    ssd_scan.launches += 1
    ssd_scan.narrow += not all(vec)
    if err != 0:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error "
                           f"{err}")
    return y


ssd_scan.launches = 0
ssd_scan.narrow = 0
