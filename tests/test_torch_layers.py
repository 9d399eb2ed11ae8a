"""The port's shared model layers (``repro_torch.models.layers``) against
the JAX package's (``repro.models.layers``): RoPE's frequencies and its
application in the prefill form ``[B, H, S, D]`` and the decode form
``[B, H, 1, D]`` (positions up to 32 767, the long decode cache), and the
two FFNs, in f32 and bf16. Inputs come from numpy with a seed.

Tolerances, with their reasons:

- ``rope_freqs``: the two packages may round ``theta ** (i / dim)`` one ulp
  apart (they do at theta 5e6, dim 128), and the angle ``pos · inv_i``
  carries that ulp times the position. So cos and sin are held elementwise
  to 2e-7 + pos · inv_i · 2^-22: two ulps of the angle's frequency, plus
  one ulp of a value in [-1, 1].
- ``apply_rope`` on the same cos/sin: f32 1e-6 relative (the same products
  and sums); bf16 one bf16 ulp (2^-8 relative) — both compute in f32 and
  round once. On each package's own tables (the decode form): f32 1e-4 of
  max|out|, the tables' gap above times |x| (1.8e-5 measured at position
  32 767); bf16 2e-2.
- ``swiglu`` / ``gelu_mlp``: f32 1e-5 of max|out| (products summed in
  another order over d_ff); bf16 2e-2 of max|out|, the reference's bf16
  kernel tolerance — the two frameworks round the bf16 projections and the
  activation at other places, a few bf16 ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jx_layers

from repro_torch.models import layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("theta", [1e4, 1e5, 1e6, 5e6])
@pytest.mark.parametrize("dim", [32, 128])
def test_rope_freqs_match_reference(theta, dim):
    pos = np.array([0, 1, 2, 63, 2047, 4095, 32752, 32767], np.int32)
    jc, js = jx_layers.rope_freqs(jnp.asarray(pos), dim, theta)
    pc, ps = layers.rope_freqs(torch.from_numpy(pos), dim, theta)
    assert pc.dtype == ps.dtype == torch.float32
    assert tuple(pc.shape) == jc.shape == (len(pos), dim // 2)
    inv = 1.0 / theta ** (np.arange(0, dim, 2) / dim)
    tol = 2e-7 + pos[:, None] * inv[None, :] * 2.0 ** -22
    assert (np.abs(pc.numpy() - np.asarray(jc)) <= tol).all()
    assert (np.abs(ps.numpy() - np.asarray(js)) <= tol).all()


def _rope_tables(pos, dim, theta):
    """cos/sin made once (numpy, f32) and handed to both packages."""
    inv = (1.0 / theta ** (np.arange(0, dim, 2) / dim)).astype(np.float32)
    ang = pos.astype(np.float32)[:, None] * inv
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _rope_tol(dtype):
    return (dict(rtol=2.0 ** -8, atol=1e-6) if dtype == "bfloat16"
            else dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_rope_prefill_form_matches_reference(dtype):
    """x [B, H, S, D] with cos/sin [S, D/2], as ``_gqa_full`` calls it (x a
    transposed view of the projection in the port)."""
    b, h, s, d = 2, 4, 64, 32
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    cos, sin = _rope_tables(np.arange(s), d, 5e6)
    (jx,), (px,) = _both([x], dtype)
    want = jx_layers.apply_rope(jx.transpose(0, 2, 1, 3), jnp.asarray(cos),
                                jnp.asarray(sin))
    got = layers.apply_rope(px.transpose(1, 2), torch.from_numpy(cos),
                            torch.from_numpy(sin))
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_rope_tol(dtype))


@pytest.mark.parametrize("pos", [0, 1, 4095, 32752, 32767])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_rope_decode_form_matches_reference(dtype, pos):
    """x [B, H, 1, D] with cos/sin [1, D/2] of one position, as
    ``_gqa_decode`` calls it, up to the long cache's last position."""
    b, h, d = 3, 8, 128
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((b, h, d)).astype(np.float32)
    cos, sin = _rope_tables(np.array([pos]), d, 5e6)
    (jx,), (px,) = _both([x], dtype)
    want = jx_layers.apply_rope(jx[:, :, None], jnp.asarray(cos),
                                jnp.asarray(sin))[:, :, 0]
    got = layers.apply_rope(px[:, :, None], torch.from_numpy(cos),
                            torch.from_numpy(sin))[:, :, 0]
    np.testing.assert_allclose(_f32(got), _f32(want), **_rope_tol(dtype))
    # and with each package's own tables, as the models make them
    jc, js = jx_layers.rope_freqs(jnp.asarray([pos]), d, 5e6)
    pc, ps = layers.rope_freqs(torch.tensor([pos]), d, 5e6)
    own = layers.apply_rope(px[:, :, None], pc, ps)[:, :, 0]
    ref = jx_layers.apply_rope(jx[:, :, None], jc, js)[:, :, 0]
    assert _rel(own, ref) <= (2e-2 if dtype == "bfloat16" else 1e-4)


def _ffn_tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-5


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_swiglu_matches_reference(dtype):
    rng = np.random.default_rng(1)
    d, f = 128, 352
    arrays = [rng.standard_normal((2, 16, d)).astype(np.float32),
              (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32),
              (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32),
              (rng.standard_normal((f, d)) * f ** -0.5).astype(np.float32)]
    jargs, pargs = _both(arrays, dtype)
    want = jx_layers.swiglu(*jargs)
    got = layers.swiglu(*pargs)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    assert _rel(got, want) <= _ffn_tol(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gelu_mlp_matches_reference(dtype):
    rng = np.random.default_rng(2)
    d, f = 96, 384
    arrays = [rng.standard_normal((3, d)).astype(np.float32),
              (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32),
              (rng.standard_normal((f, d)) * f ** -0.5).astype(np.float32)]
    jargs, pargs = _both(arrays, dtype)
    want = jx_layers.gelu_mlp(*jargs)
    got = layers.gelu_mlp(*pargs)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    assert _rel(got, want) <= _ffn_tol(dtype)
