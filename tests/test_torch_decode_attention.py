"""The plain version of the port's decode attention (what the wrapper runs
on CPU tensors) against the JAX package's Pallas kernel in interpret mode
and its jnp oracle.

- ``decode`` / ``decode_attention`` / ``decode_ref`` over
  ``tests/test_kernels.py``'s sweep (GQA, MHA, MQA; f32 and bf16) and its
  ragged ``kv_len`` case, at the reference's tolerances: f32 2e-5 (the two
  differ only in the order of f32 sums and in the online softmax's
  rescaling, a few ulp), bf16 2e-2 (both round an f32 result to bf16 once:
  one bf16 ulp is 2^-8 relative);
- a ragged S (not a multiple of the kernel's 64-position tile, with
  ``kv_len`` past S clamped) and a cache with replicated KV heads (the
  layout of ``init_cache(kv_head_pad=...)``) against ``repro``'s
  ``decode_ref``;
- the host's choice of the kernel's cache ranges (``split_plan``) and of
  the partials kernel (``uses_ring``: the tensor-core kernel for bf16 rows
  it can read, the CUDA-core kernel for the rest);
- ``decode_bf16_p_ref``, the tensor-core kernel's rounding in plain
  PyTorch (P rounded to bf16 before P·V), against the Pallas kernel and
  ``decode_ref`` at bf16 2e-2, and equal to ``decode_ref`` at 2e-5 in f32
  (where it rounds nothing).

Inputs come from numpy with a seed and go to both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import (
    decode_attention as jx_decode_attention)
from repro.kernels.decode_attention.ref import decode_ref as jx_decode_ref

from repro_torch.kernels.decode_attention import (decode, decode_attention,
                                                  decode_bf16_p_ref,
                                                  decode_ref)
from repro_torch.kernels.decode_attention.decode_attention import (
    TS, _vec_ok, split_plan, uses_ring)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(seed, b, hq, hkv, s, d, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("b,hq,hkv,s,d,bs", [
    (2, 8, 2, 256, 64, 64),
    (1, 4, 4, 512, 128, 128),
    (4, 16, 1, 128, 64, 64),  # MQA
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_reference_sweep(b, hq, hkv, s, d, bs, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(5, b, hq, hkv, s, d, dtype)
    before = decode_attention.launches
    got = decode(tq, tk, tv)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, hq, d)
    assert decode_attention.launches == before     # CPU: no kernel launch
    kernel = jx_decode_attention(jq, jk, jv, bs=bs, interpret=True)
    oracle = jx_decode_ref(jq, jk, jv)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(oracle), **_tol(dtype))
    np.testing.assert_array_equal(_f32(decode_ref(tq, tk, tv)), _f32(got))


def test_plain_matches_reference_ragged_lengths():
    b, hq, hkv, s, d = 3, 4, 2, 256, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(6, b, hq, hkv, s, d, "float32")
    kv_len = np.array([256, 100, 17], np.int32)
    got = decode(tq, tk, tv, torch.from_numpy(kv_len))
    want = jx_decode_attention(jq, jk, jv, jnp.asarray(kv_len), bs=64,
                               interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _f32(got), _f32(jx_decode_ref(jq, jk, jv, jnp.asarray(kv_len))),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_reference_ragged_cache_length(dtype):
    """S = 200 (no tiling by 64): the reference's kernel needs S % bs == 0,
    its oracle does not; kv_len past S reads as S."""
    b, hq, hkv, s, d = 3, 8, 2, 200, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, b, hq, hkv, s, d, dtype)
    kv_len = np.array([200, 130, 1], np.int32)
    got = decode(tq, tk, tv, torch.from_numpy(kv_len))
    want = jx_decode_ref(jq, jk, jv, jnp.asarray(kv_len))
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    past = decode(tq, tk, tv, torch.tensor([500, 130, 1], dtype=torch.int32))
    np.testing.assert_array_equal(_f32(past), _f32(got))


def test_plain_reads_a_cache_with_replicated_heads():
    """A cache holding each of Hkv heads ``pad`` times (Hkv · pad heads)
    gives the same output as the unpadded cache: q head h reads cache head
    h // (Hq / (Hkv · pad)), a copy of head h // (Hq / Hkv)."""
    b, hq, hkv, s, d, pad = 2, 8, 2, 128, 32, 2
    (jq, jk, jv), (tq, tk, tv) = _inputs(8, b, hq, hkv, s, d, "float32")
    kv_len = np.array([128, 40], np.int32)
    tkp, tvp = (t.repeat_interleave(pad, dim=1) for t in (tk, tv))
    got = decode(tq, tkp, tvp, torch.from_numpy(kv_len))
    want = jx_decode_ref(jq, jnp.repeat(jk, pad, axis=1),
                         jnp.repeat(jv, pad, axis=1), jnp.asarray(kv_len))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _f32(got), _f32(decode(tq, tk, tv, torch.from_numpy(kv_len))),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 129, 200, 4096, 32768,
                               100_000])
@pytest.mark.parametrize("rows", [1, 4, 32, 264, 1000])
@pytest.mark.parametrize("ts", [TS, 128])    # CUDA-core, tensor-core tile
def test_split_plan_covers_the_cache(s, rows, ts):
    for slots in (132, 2 * 132, 3 * 132):     # an H100's SMs x blocks each
        chunk, n_split = split_plan(s, rows, slots, ts)
        assert chunk % ts == 0 and chunk > 0
        assert (n_split - 1) * chunk < s <= n_split * chunk   # none empty
        tiles = -(-s // ts)
        assert n_split <= max(tiles, 1)
        assert rows * n_split <= max(slots, rows)             # one wave
        if tiles >= slots // rows:          # enough cache to fill the card
            assert 2 * n_split > slots // rows


@pytest.mark.parametrize("b,hq,hkv,s,d,bs", [
    (2, 8, 2, 256, 64, 64),
    (1, 4, 4, 512, 128, 128),
    (4, 16, 1, 128, 64, 64),  # MQA
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bf16_p_ref_matches_reference_sweep(b, hq, hkv, s, d, bs, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(5, b, hq, hkv, s, d, dtype)
    got = decode_bf16_p_ref(tq, tk, tv)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, hq, d)
    kernel = jx_decode_attention(jq, jk, jv, bs=bs, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(jx_decode_ref(jq, jk, jv)),
                               **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(decode_ref(tq, tk, tv)),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bf16_p_ref_matches_reference_ragged(dtype):
    """The reference's ragged case (kv_len [256, 100, 17], its kernel at
    bs 64) and a ragged S = 200 (its oracle), with kv_len past S."""
    b, hq, hkv, s, d = 3, 4, 2, 256, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(6, b, hq, hkv, s, d, dtype)
    kv_len = np.array([256, 100, 17], np.int32)
    got = decode_bf16_p_ref(tq, tk, tv, torch.from_numpy(kv_len))
    want = jx_decode_attention(jq, jk, jv, jnp.asarray(kv_len), bs=64,
                               interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_allclose(
        _f32(got), _f32(decode_ref(tq, tk, tv, torch.from_numpy(kv_len))),
        **_tol(dtype))
    b, hq, hkv, s, d = 3, 8, 2, 200, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, b, hq, hkv, s, d, dtype)
    kv_len = np.array([200, 130, 1], np.int32)
    got = decode_bf16_p_ref(tq, tk, tv, torch.tensor([500, 130, 1]))
    want = jx_decode_ref(jq, jk, jv, jnp.asarray(kv_len))
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("s,lens", [(200, (200, 63, 1)), (333, (333, 65, 191)),
                                    (1000, (1000, 193, 640))])
def test_bf16_p_ref_in_f32_is_decode_ref(s, lens):
    """In f32 nothing is rounded: only the order of the sums differs."""
    (_, _, _), (tq, tk, tv) = _inputs(9, 3, 8, 2, s, 64, "float32")
    kv_len = torch.tensor(lens, dtype=torch.int32)
    np.testing.assert_allclose(_f32(decode_bf16_p_ref(tq, tk, tv, kv_len)),
                               _f32(decode_ref(tq, tk, tv, kv_len)),
                               rtol=2e-5, atol=2e-5)


def test_bf16_p_ref_rounds_p_only_in_bf16():
    """Rounding P moves a bf16 result by far less than the tolerance, yet
    it does move it: the function is not ``decode_ref`` under a new
    name."""
    (_, _, _), (tq, tk, tv) = _inputs(10, 2, 8, 2, 512, 128, "bfloat16")
    ring = decode_bf16_p_ref(tq, tk, tv).float()
    plain = decode_ref(tq, tk, tv).float()
    unrounded = decode_bf16_p_ref(tq.float(), tk.float(), tv.float())
    gap = float((ring - plain).abs().max())
    assert 0 < gap <= 2e-2
    np.testing.assert_allclose(_f32(unrounded), _f32(decode_ref(
        tq.float(), tk.float(), tv.float())), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,d,vec,ring", [
    (torch.bfloat16, 128, True, True), (torch.bfloat16, 64, True, True),
    (torch.bfloat16, 16, True, True), (torch.bfloat16, 80, True, True),
    (torch.bfloat16, 8, True, False), (torch.bfloat16, 20, False, False),
    (torch.bfloat16, 128, False, False), (torch.float32, 128, True, False),
])
def test_uses_ring_takes_bf16_rows_it_can_read(dtype, d, vec, ring):
    assert uses_ring(dtype, d, vec) is ring


def test_vec_layout_of_the_model_cache_and_of_views():
    """The model's cache [B, Hkv, S, D] bf16 is read 16 bytes at a time;
    a view one element into its rows or with D not contiguous is not."""
    k = torch.zeros((2, 4, 64, 128), dtype=torch.bfloat16)
    assert _vec_ok(k, 8)
    assert not _vec_ok(k[..., 1:121], 8)
    assert not _vec_ok(k.transpose(2, 3), 8)
    assert not _vec_ok(torch.zeros((2, 4, 64, 20), dtype=torch.bfloat16), 8)
