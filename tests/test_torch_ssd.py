"""The plain versions of the port's SSD scan (what ``ssd`` and the wrapper
run on CPU tensors) against the JAX package's Pallas kernel in interpret
mode and its token-recurrence oracle, over ``tests/test_kernels.py``'s
sweep, with the state carried across chunks (Q = 32 and 128 at L = 256),
a length that does not tile, and a chunk of 256 at d_state 128. Then the
CUDA kernel's arithmetic in plain PyTorch (``ssd_bf16_operands_ref``)
against the bounds the card is held to, and the wrapper's plan of the
kernels' tiles and scratch.

Tolerances are the reference's. f32 2e-4: the chunked algorithm and the
token recurrence sum the same terms in other orders, through exp of
cumulative sums (a few ulp each) over up to 256 steps. bf16 5e-2: the
JAX package's kernel rounds dt·x to bf16 before the scan (ssd_scan.py:80)
and its skip to bf16 before adding it (:108), where the port's chunked
plain version keeps both in f32 and rounds y once; each rounding is 2^-8
relative, and 5e-2 covers a few of them on outputs of order 1. Inputs come
from numpy with a seed and go to both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_chunked_ref as jx_chunked
from repro.kernels.ssd_scan.ref import ssd_ref as jx_ssd_ref
from repro.kernels.ssd_scan.ssd_scan import ssd_scan as jx_ssd_scan

from repro_torch.kernels.ssd_scan import (ssd, ssd_bf16_operands_ref,
                                          ssd_chunked_ref, ssd_ref, ssd_scan)
from repro_torch.kernels.ssd_scan.ssd_scan import plan, vec_ok

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (dict(rtol=5e-2, atol=5e-2) if name == "bfloat16"
            else dict(rtol=2e-4, atol=2e-4))


def _inputs(seed, b, l, h, g, p, n, dt_scale=0.1, a_scale=0.5):
    """x, dt, a, B, C, D as in ``tests/test_kernels.py``: dt = 0.1 ·
    softplus(N(0, 1)), A = -exp(0.5 · N(0, 1)), B and C N(0, 1/4)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((b, l, h)), 0) * dt_scale
          ).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * a_scale)).astype(np.float32)
    bm = (rng.standard_normal((b, l, g, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, l, g, n)) * 0.5).astype(np.float32)
    d = np.full((h,), 0.5, np.float32)
    return x, dt, a, bm, cm, d


def _jax(arrays, dtype):
    x, dt, a, bm, cm, d = arrays
    jdt = DTYPES[dtype][0]
    return (jnp.asarray(x).astype(jdt), jnp.asarray(dt).astype(jdt),
            jnp.asarray(a), jnp.asarray(bm).astype(jdt),
            jnp.asarray(cm).astype(jdt), jnp.asarray(d))


def _torch(arrays, dtype):
    x, dt, a, bm, cm, d = (torch.from_numpy(v) for v in arrays)
    tdt = DTYPES[dtype][1]
    return x.to(tdt), dt.to(tdt), a, bm.to(tdt), cm.to(tdt), d


SWEEP = [(1, 128, 2, 1, 32, 16, 64),
         (2, 256, 4, 2, 64, 32, 128),
         (1, 64, 8, 8, 16, 16, 32)]      # one head per group


@pytest.mark.parametrize("b,l,h,g,p,n,q", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_reference_sweep(b, l, h, g, p, n, q, dtype):
    arrays = _inputs(7, b, l, h, g, p, n)
    jx_in, pt_in = _jax(arrays, dtype), _torch(arrays, dtype)
    want_pallas = np.asarray(jx_ssd_scan(*jx_in, q_chunk=q, interpret=True),
                             np.float32)
    want_ref = np.asarray(jx_ssd_ref(*jx_in), np.float32)
    for got in (ssd(*pt_in, q_chunk=q), ssd_scan(*pt_in, q_chunk=q),
                ssd_chunked_ref(*pt_in, q_chunk=q), ssd_ref(*pt_in)):
        assert got.dtype == pt_in[0].dtype and got.shape == (b, l, h, p)
        got = got.float().numpy()
        np.testing.assert_allclose(got, want_pallas, **_tol(dtype))
        np.testing.assert_allclose(got, want_ref, **_tol(dtype))


@pytest.mark.parametrize("q", [32, 128])
def test_state_carries_across_chunks(q):
    """Chunked result must match the recurrence even when L >> chunk (the
    reference's own carry test, D omitted)."""
    arrays = _inputs(8, 1, 256, 2, 1, 16, 8, dt_scale=0.2, a_scale=0.3)
    jx_in, pt_in = _jax(arrays, "float32")[:5], _torch(arrays, "float32")[:5]
    want = np.asarray(jx_ssd_scan(*jx_in, None, q_chunk=q, interpret=True))
    np.testing.assert_allclose(np.asarray(jx_ssd_ref(*jx_in)), want,
                               rtol=2e-4, atol=2e-4)
    for got in (ssd(*pt_in, q_chunk=q), ssd_chunked_ref(*pt_in, q_chunk=q)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_chunked_plain_matches_reference_chunked():
    """The two chunked plain versions compute the same f32 algorithm: they
    agree far inside the recurrence's tolerance."""
    arrays = _inputs(9, 2, 256, 4, 2, 32, 16)
    want = np.asarray(jx_chunked(*_jax(arrays, "float32"), q_chunk=64))
    got = ssd_chunked_ref(*_torch(arrays, "float32"), q_chunk=64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_untiled_length_takes_the_recurrence():
    """L = 100 does not tile by Q = 32: on the CPU ``ssd`` follows the JAX
    package's off-TPU rule and runs the token recurrence; the chunked plain
    version refuses the length."""
    arrays = _inputs(11, 1, 100, 4, 2, 16, 8)
    want = np.asarray(jx_ssd_ref(*_jax(arrays, "float32")))
    pt_in = _torch(arrays, "float32")
    got = ssd(*pt_in, q_chunk=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got, ssd_ref(*pt_in), rtol=0, atol=0)
    with pytest.raises(ValueError):
        ssd_chunked_ref(*pt_in, q_chunk=32)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    pt_in = _torch(_inputs(12, 1, 64, 2, 1, 16, 8), "float32")
    before = ssd_scan.launches
    torch.testing.assert_close(ssd(*pt_in, q_chunk=32),
                               ssd_chunked_ref(*pt_in, q_chunk=32),
                               rtol=0, atol=0)
    assert ssd_scan.launches == before


def test_cuda_only_checks_refuse_mixed_devices():
    """A wrapper never moves operands between devices: CPU operands with a
    tensor claiming another device raise before any launch."""
    x, dt, a, bm, cm, d = _torch(_inputs(13, 1, 32, 2, 1, 16, 8), "float32")
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a.to("meta"), bm, cm, d)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunk_of_256_at_d_state_128(dtype):
    """Fault C1's shape: Q = 256 with N = 128 (mamba2-1.3b's d_state), which
    the reference takes; the state carries across the two chunks. Both
    packages' chunked kernels (the JAX one in interpret mode) and both
    token recurrences agree."""
    arrays = _inputs(14, 1, 512, 2, 1, 16, 128)
    jx_in, pt_in = _jax(arrays, dtype), _torch(arrays, dtype)
    want_pallas = np.asarray(jx_ssd_scan(*jx_in, q_chunk=256, interpret=True),
                             np.float32)
    want_ref = np.asarray(jx_ssd_ref(*jx_in), np.float32)
    for got in (ssd(*pt_in, q_chunk=256), ssd_scan(*pt_in, q_chunk=256),
                ssd_bf16_operands_ref(*pt_in, q_chunk=256)):
        assert got.dtype == pt_in[0].dtype and got.shape == (1, 512, 2, 16)
        got = got.float().numpy()
        np.testing.assert_allclose(got, want_pallas, **_tol(dtype))
        np.testing.assert_allclose(got, want_ref, **_tol(dtype))


# ------------------------------------------- the kernel's arithmetic (B3)

# ssd_bf16_operands_ref against ssd_chunked_ref, as chip_smoke.py holds the
# kernel: whole output max|a - b| / max(1, max|b|) and per (batch, head)
# against the head's own max|b|. f32: the same function with sums in
# another order (5.7e-7 of a head at mamba2-1.3b's layer,
# scripts/torch_ssd_rounding.py); bf16: the scores, x·dt·exp(cum_Q - cum)
# and the chunk states rounded to bf16, 7.3e-3 of a head there.
ROW_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
WHOLE_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _gaps(got, want):
    got, want = got.double(), want.double()
    whole = float((got - want).abs().max() / max(1.0, float(want.abs().max())))
    diff = (got - want).abs().transpose(1, 2).flatten(2).amax(-1)
    size = want.abs().transpose(1, 2).flatten(2).amax(-1)
    return whole, float((diff / size).max())


@pytest.mark.parametrize("b,l,h,g,p,n,q", SWEEP + [
    (2, 512, 4, 1, 64, 128, 128), (1, 512, 2, 1, 16, 128, 256)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_arithmetic_within_the_kernel_tolerance(b, l, h, g, p, n, q,
                                                       dtype):
    """The kernel's roundings, computed on the CPU, stay inside the bounds
    the card is held to, whole and per (batch, head)."""
    pt_in = _torch(_inputs(15, b, l, h, g, p, n), dtype)
    whole, row = _gaps(ssd_bf16_operands_ref(*pt_in, q_chunk=q),
                       ssd_chunked_ref(*pt_in, q_chunk=q))
    assert whole <= WHOLE_TOL[dtype] and row <= ROW_TOL[dtype]
    if dtype == "float32":        # nothing rounded: sums in another order
        assert row <= 1e-5


@pytest.mark.parametrize("l,q", [(100, 32), (200, 128), (7, 4), (300, 256)])
def test_kernel_arithmetic_masks_a_ragged_last_chunk(l, q):
    """L not a multiple of Q: the kernel's arithmetic pads the last chunk
    with zero rows and matches the token recurrence of both packages."""
    arrays = _inputs(16, 2, l, 4, 2, 16, 8)
    want = np.asarray(jx_ssd_ref(*_jax(arrays, "float32")))
    got = ssd_bf16_operands_ref(*_torch(arrays, "float32"), q_chunk=q)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


# ----------------------------------------------------- the wrapper's plan

def test_plan_at_mamba2_layer():
    """mamba2-1.3b's layer at prefill, bf16, Q 128: 16 chunks, four
    kernels; the scratch holds dt and cum (2 MiB each), C Bᵀ per group
    (4 MiB) and the 15 states entering chunks 1..15 per (batch, head) in
    bf16 (60 MiB), each piece 256-byte aligned."""
    pl = plan(4, 2048, 64, 1, 64, 128, 128, 2)
    assert (pl.q, pl.qp, pl.nc, pl.npd, pl.ppd, pl.kernels) == (
        128, 128, 16, 128, 64, 4)
    assert pl.offsets == (0, 2 ** 21, 2 ** 22, 2 ** 23)
    assert pl.nbytes == 2 ** 23 + 256 * 15 * 128 * 64 * 2
    assert plan(4, 2048, 64, 1, 64, 128, 256, 2).kernels == 4


@pytest.mark.parametrize("l,q,qp,nc", [(7, 4, 64, 2), (48, 128, 64, 1),
                                       (1000, 256, 256, 4), (96, 48, 64, 2),
                                       (1024, 512, 512, 2)])
def test_plan_pads_chunks_to_whole_tiles(l, q, qp, nc):
    """Every Q >= 1 is cut into 64-row tiles (the chunk is min(Q, L)); one
    chunk needs no states and three kernels; no piece overlaps another."""
    pl = plan(2, l, 4, 2, 80, 24, q, 4)
    assert (pl.qp, pl.nc, pl.npd, pl.ppd) == (qp, nc, 64, 128)
    assert pl.q == min(q, l) and pl.kernels == (4 if nc > 1 else 3)
    sizes = (4 * 8 * nc * qp, 4 * 8 * nc * qp, 4 * 4 * nc * qp * qp,
             4 * 8 * (nc - 1) * 64 * 128)
    ends = [off + size for off, size in zip(pl.offsets, sizes)]
    assert all(off % 256 == 0 for off in pl.offsets)
    assert all(e <= o for e, o in zip(ends, pl.offsets[1:] + (pl.nbytes,)))
    with pytest.raises(ValueError):
        plan(2, l, 4, 2, 80, 24, 0, 4)


def test_vec_ok_takes_the_model_layout_only():
    """The model's x, B and C (views of one [B, L, 4352] bf16 projection)
    are copied 16 bytes at a time; a projection 5 elements wider is not."""
    proj = torch.zeros((2, 16, 4352), dtype=torch.bfloat16)
    x, bm, cm = proj.split([4096, 128, 128], dim=-1)
    views = (x.unflatten(-1, (64, 64)), bm.unflatten(-1, (1, 128)),
             cm.unflatten(-1, (1, 128)))
    assert all(vec_ok(v) for v in views)
    wide = torch.zeros((2, 16, 4357), dtype=torch.bfloat16)
    assert not vec_ok(wide[..., :4096].unflatten(-1, (64, 64)))
    assert not vec_ok(torch.zeros((2, 16, 4, 12), dtype=torch.bfloat16))
    assert vec_ok(torch.zeros((2, 16, 4, 12), dtype=torch.float32))
