"""The plain versions of the port's SSD scan (what ``ssd`` and the wrapper
run on CPU tensors) against the JAX package's Pallas kernel in interpret
mode and its token-recurrence oracle, over ``tests/test_kernels.py``'s
sweep, with the state carried across chunks (Q = 32 and 128 at L = 256)
and a length that does not tile.

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

from repro_torch.kernels.ssd_scan import (ssd, ssd_chunked_ref, ssd_ref,
                                          ssd_scan)

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
