"""The benchmark's yardstick: the card's peaks, the least time of a task,
TF32 rounding for the control, and the statistics of a window.

Nothing here imports the program: a change to the program cannot move the
measure it is held to.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# NVIDIA H100 SXM, data sheet, dense rates, at its 700 W power limit
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12        # HBM3 bytes/s


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card can take for work of ``flops`` f32
    operations that moves ``nbytes``: the larger of the two bounds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def gemm_task(m: int, n: int, k: int, operands: int) -> tuple:
    """(flops, bytes) of one f32 task ``C = X - A @ B`` on ``m x k`` and
    ``k x n`` blocks: 2mnk operations; ``operands`` distinct input blocks
    each read once and the output written once."""
    return 2.0 * m * n * k, 4.0 * (operands + 1) * m * n


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32, the tensor cores' 10-bit mantissa,
    to nearest with ties away from zero, and held in float32: an f32
    product of rounded operands is what a TF32 product computes."""
    if x.dtype != torch.float32:
        raise TypeError(f"to_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def input_seed(seed: int, index: int) -> int:
    """A 63-bit seed for input ``index`` of a run of ``seed``: any whole
    ``seed`` gives distinct, well-mixed generators for its inputs."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), index])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def sampler(seed: int) -> np.random.Generator:
    """The generator that picks which steps of a window are checked."""
    return np.random.default_rng(
        np.random.SeedSequence([abs(int(seed)), int(seed < 0), 7919]))


def p95(values: Sequence[float]) -> float:
    """95th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def union_s(intervals: np.ndarray) -> float:
    """Seconds covered by the union of ``[start_ns, end_ns)`` rows."""
    if len(intervals) == 0:
        return 0.0
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    # a row starts a new run where it begins after every earlier row ended
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    run_end = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
    return float((run_end - starts).sum()) / 1e9


def gaps(intervals: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The idle gaps ``[start_ns, end_ns)`` inside ``[lo, hi)`` that the
    union of ``intervals`` leaves, longest first."""
    if len(intervals) == 0:
        return np.array([[lo, hi]], dtype=np.int64)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    g_start = np.concatenate(([lo], ends))
    g_end = np.concatenate((iv[:, 0], [hi]))
    g_start = np.maximum(g_start, lo)
    g_end = np.minimum(g_end, hi)
    keep = g_end > g_start
    out = np.stack([g_start[keep], g_end[keep]], axis=1)
    return out[np.argsort(out[:, 0] - out[:, 1], kind="stable")]
