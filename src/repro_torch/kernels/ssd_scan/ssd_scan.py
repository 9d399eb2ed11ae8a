"""Wrapper of the hand-written Hopper SSD scan (``csrc/ssd_scan.cu``).

The port of the JAX package's Pallas kernel ``ssd_scan``
(``src/repro/kernels/ssd_scan/ssd_scan.py``): the Mamba-2 SSD, chunk by
chunk, with the [N, P] state carried across chunks and the D skip added in
the same pass. The CUDA kernel reads x, dt, B and C through their own
strides, maps each head to its group, and masks a ragged last chunk, so
every L works. See the note at the top of the source for what bounds it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from .ref import ssd_chunked_ref, ssd_ref

_DTYPES = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_PT, _RT, _THREADS = 64, 32, 256    # the kernel's P slice, score rows, threads
SMEM_LIMIT = 232448                 # bytes a block may use on Hopper
_INT_MAX = 2 ** 31 - 1


@functools.cache
def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, with its argument types declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = getattr(_build.load("ssd_scan"), _DTYPES[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(q: int, n: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block: dt·x [Q][64], the state [N][64],
    the scores [32][Q + 1], the cumsum and scan totals in f32, and the
    chunk's B and C [Q][N + pad] in the input dtype (rows padded to an odd
    number of 32-bit words)."""
    size = torch.tensor([], dtype=dtype).element_size()
    row = n + 1 if size == 4 else n + 2
    return 4 * (q * _PT + n * _PT + _RT * (q + 1) + q + 8) + 2 * q * row * size


def _plain(x, dt, a, b, c, d, q_chunk):
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
    tensors it launches the kernel, on the current stream, or raises.
    ``ssd_scan.launches`` counts the launches."""
    ops = (x, dt, a, b, c) + ((d,) if d is not None else ())
    if all(t.device.type == "cpu" for t in ops):
        return _plain(x, dt, a, b, c, d, q_chunk)
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
    q = min(q_chunk, l)
    if not 1 <= q <= _THREADS:
        raise ValueError(f"ssd_scan: chunk {q} outside [1, {_THREADS}]")
    smem = smem_bytes(q, n, x.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {q} x d_state {n} in {x.dtype} "
                         f"needs {smem} bytes of shared memory > {SMEM_LIMIT}")
    if max(bsz * h, l) > _INT_MAX:
        raise ValueError("ssd_scan: a dimension exceeds 2**31 - 1")
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    a32 = a.to(torch.float32).contiguous()
    d32 = d.to(torch.float32).contiguous() if d is not None else None
    strides = (ctypes.c_longlong * 15)(*x.stride(), *dt.stride(), *b.stride(),
                                       *c.stride())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(x.dtype)(x.data_ptr(), dt.data_ptr(), a32.data_ptr(),
                              b.data_ptr(), c.data_ptr(),
                              d32.data_ptr() if d32 is not None else None,
                              y.data_ptr(), bsz, l, h, g, p, n, q, strides,
                              smem, stream)
    ssd_scan.launches += 1
    if err != 0:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error "
                           f"{err}")
    return y


ssd_scan.launches = 0
