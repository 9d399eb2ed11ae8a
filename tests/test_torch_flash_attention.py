"""The plain version of the port's flash attention (what the wrapper runs on
CPU tensors) against the JAX package's Pallas kernel in interpret mode and
its jnp oracle, and the attention-chain PTG on the port's executor against
the JAX package's executor.

- ``attention`` / ``flash_attention`` / ``mha_ref`` over
  ``tests/test_kernels.py``'s sweep (MHA, GQA, MQA, Lk > Lq, uneven tiles,
  causal and full), the long-sequence case, and the executor's batched
  ``task_attention`` form against ``vmap(task_attention)``. Tolerances are
  the reference's: f32 2e-5 (the two differ only in the order of f32 sums
  and in the online softmax's rescaling, a few ulp), bf16 2e-2 (both round
  an f32 result to bf16 once: one bf16 ulp is 2^-8 relative).
- The attention chain of ``multi_device_cases.case_pallas_bodies`` (depth 6,
  seq 32, dim 16, 2 shards), on the port's executor with ``task_attention``
  bodies (the plain version on the CPU), against the JAX package's executor
  on ``mha_ref`` bodies, run once in a subprocess with 2 forced host
  devices, at 2e-5. The JAX package's ``pallas_bodies`` case itself fails
  under jax 0.9.0 (ROADMAP, "Reference caveats"); its jnp-body lowering
  runs.

- The sliding window (``window`` > 0: keys ``window`` or more positions
  before their query are masked) of ``mha_ref``, ``flash_attention`` and
  ``attention`` on CPU tensors, against the JAX package's
  ``chunked_attention(window=)`` (its ``mha_ref`` and Pallas kernel have no
  window) over windows {1, 7, 64, >= Lk} x causal and full x Lq = Lk and
  Lq < Lk x D {64, 128} x GQA groups {1, 4, 7}, at 2e-5; the bf16 kernel's
  rounding with a window (``mha_bf16_p_ref``) at 2e-2; and non-causal
  attention with Lq > Lk and Lq < Lk (the encdec family's encoder and
  cross-attention) against the Pallas kernel and ``chunked_attention``.
- The host side of the CUDA kernel, which runs before any launch: the f32
  path's split plan (every live key of a query tile in exactly one range,
  from the first tile the window reaches to the causal bound, the same
  plan whatever the batch) and the
  bf16 path's layout check (a copy exactly where TMA cannot read the
  operand). And the bf16 path's one extra rounding in plain form
  (``mha_bf16_p_ref``: P rounded to bf16 before P·V) against ``mha_ref``
  and the JAX package's kernel, at the reference's bf16 tolerance 2e-2, on
  the whole tensor and per (batch, q head).

Inputs come from numpy with a seed and go to both frameworks. Run as a
script (``python tests/test_torch_flash_attention.py OUT.npz``) this file
writes the JAX package's attention-chain outputs.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention as jx_flash_attention)
from repro.kernels.flash_attention.ops import task_attention as jx_task_attn
from repro.kernels.flash_attention.ref import mha_ref as jx_mha_ref
from repro.models.attention import chunked_attention as jx_chunked

from repro_torch.kernels.flash_attention import (attention, flash_attention,
                                                 mha_bf16_p_ref, mha_ref,
                                                 task_attention)
from repro_torch.kernels.flash_attention.flash_attention import (
    KernelInfo, _tma_operand, needs_copy, plan_for, split_plan)
from repro_torch.ptg import Graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CHAIN = dict(depth=6, seq=32, dim=16, n_shards=2)


def _tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


# ------------------------------------------------- the kernel's plain form

@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,bq,bk", [
    (1, 4, 4, 128, 128, 64, 64, 64),     # MHA
    (2, 8, 2, 128, 128, 64, 64, 64),     # GQA 4:1
    (1, 4, 1, 64, 256, 32, 64, 64),      # MQA, kv longer than q
    (1, 2, 2, 256, 256, 128, 128, 64),   # uneven q/kv tiles
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_reference_sweep(b, hq, hkv, lq, lk, d, bq, bk, causal,
                                       dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(1, (b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)), dtype)
    want_pallas = np.asarray(jx_flash_attention(
        jq, jk, jv, causal=causal, bq=bq, bk=bk, interpret=True), np.float32)
    want_ref = np.asarray(jx_mha_ref(jq, jk, jv, causal=causal), np.float32)
    for got in (mha_ref(tq, tk, tv, causal=causal),
                flash_attention(tq, tk, tv, causal=causal),
                attention(tq, tk, tv, causal=causal)):
        assert got.dtype == tq.dtype and got.shape == (b, hq, lq, d)
        got = got.float().numpy()
        np.testing.assert_allclose(got, want_pallas, **_tol(dtype))
        np.testing.assert_allclose(got, want_ref, **_tol(dtype))


def test_plain_matches_reference_on_long_seq():
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(2, (1, 2, 512, 64), (1, 2, 512, 64), (1, 2, 512, 64)),
        "float32")
    want = np.asarray(jx_flash_attention(jq, jk, jv, causal=True, bq=128,
                                         bk=128, interpret=True))
    np.testing.assert_allclose(attention(tq, tk, tv).numpy(), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_task_attention_matches_reference(causal):
    """The executor's batched body form against ``vmap(task_attention)``
    (the fused Pallas launch, interpret mode) of the JAX package."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(10, (3, 32, 16), (3, 32, 16), (3, 32, 16)), "float32")
    want = np.asarray(jax.vmap(lambda q_, k_, v_: jx_task_attn(
        q_, k_, v_, causal=causal))(jq, jk, jv))
    got = task_attention(tq, tk, tv, causal=causal)
    assert got.shape == (3, 32, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, (2, 4, 16, 8),
                                                    (2, 2, 16, 8),
                                                    (2, 2, 16, 8)))
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, k, v), mha_ref(q, k, v),
                               rtol=0, atol=0)
    assert flash_attention.launches == before


WINDOW_SHAPES = [(1, 2, 2, 96, 96), (2, 8, 2, 40, 96), (1, 14, 2, 96, 96)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,hq,hkv,lq,lk", WINDOW_SHAPES,
                         ids=["group1", "group4-lq<lk", "group7"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("window", [1, 7, 64, 96, 200])
def test_plain_window_matches_reference_chunked_attention(window, causal, b,
                                                          hq, hkv, lq, lk,
                                                          d):
    """The window as the JAX package's ``chunked_attention`` masks it (key
    k kept for query i when k > Lk - Lq + i - window), in one block and in
    chunks of 32; a window of Lk or more masks nothing."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(20 + window, (b, hq, lq, d), (b, hkv, lk, d),
                (b, hkv, lk, d)), "float32")
    for chunk in (1024, 32):
        want = np.asarray(jx_chunked(jq, jk, jv, causal=causal,
                                     window=window, chunk=chunk))
        for got in (mha_ref(tq, tk, tv, causal=causal, window=window),
                    flash_attention(tq, tk, tv, causal=causal,
                                    window=window),
                    attention(tq, tk, tv, causal=causal, window=window)):
            assert got.shape == (b, hq, lq, d)
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                       atol=2e-5)
    if window >= lk:
        np.testing.assert_array_equal(
            mha_ref(tq, tk, tv, causal=causal, window=window).numpy(),
            mha_ref(tq, tk, tv, causal=causal).numpy())


@pytest.mark.parametrize("window", [1, 7, 64])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_p_rounding_with_a_window(window, causal):
    """The bf16 kernel's rounding (P to bf16 before P·V) with the window,
    over tiles of 32 keys so that rows meet tiles wholly before their
    window, against ``mha_ref`` and ``chunked_attention`` on the same bf16
    inputs: within the reference's bf16 tolerance, whole and per (batch,
    q head)."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(30 + window, (2, 14, 100, 64), (2, 2, 160, 64),
                (2, 2, 160, 64)), "bfloat16")
    got = mha_bf16_p_ref(tq, tk, tv, causal=causal, bk=32, window=window)
    assert got.dtype == torch.bfloat16
    for want in (mha_ref(tq, tk, tv, causal=causal, window=window),
                 np.asarray(jx_chunked(jq, jk, jv, causal=causal,
                                       window=window), np.float32)):
        whole, rows = _rel_rows(got.float().numpy(),
                                np.asarray(want.float() if isinstance(
                                    want, torch.Tensor) else want))
        assert whole <= 2e-2 and rows <= 2e-2, (whole, rows)


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (2, 4, 4, 256, 64, 64),      # Lq > Lk (more queries than keys)
    (1, 4, 4, 64, 192, 64),      # Lq < Lk (cross-attention's shape)
    (1, 14, 2, 128, 384, 128),   # GQA 7, Lq < Lk
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_full_attention_with_lq_not_lk(b, hq, hkv, lq, lk, d, dtype):
    """Non-causal attention with Lq != Lk, as the encdec family's
    cross-attention (decoder queries over encoder keys) runs it: no mask,
    whatever Lk - Lq, against the Pallas kernel (interpret mode), its jnp
    oracle and ``chunked_attention``."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(40 + lq, (b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)),
        dtype)
    wants = [np.asarray(jx_flash_attention(
        jq, jk, jv, causal=False, bq=64, bk=64, interpret=True),
        np.float32), np.asarray(jx_mha_ref(jq, jk, jv, causal=False),
                                np.float32),
        np.asarray(jx_chunked(jq, jk, jv, causal=False, chunk=64),
                   np.float32)]
    for got in (flash_attention(tq, tk, tv, causal=False),
                attention(tq, tk, tv, causal=False)):
        for want in wants:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       **_tol(dtype))


def test_plain_masks_the_keys_after_each_query():
    """Causal with Lk > Lq: query i sits at position Lk - Lq + i and sees
    exactly the keys up to it, so changing a later key leaves it alone."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, (1, 1, 4, 8),
                                                    (1, 1, 10, 8),
                                                    (1, 1, 10, 8)))
    out = mha_ref(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 7:] += 5.0                        # keys after query 0 (pos 6)
    v2[:, :, 7:] -= 3.0
    out2 = mha_ref(q, k2, v2)
    torch.testing.assert_close(out2[:, :, 0], out[:, :, 0], rtol=0, atol=0)
    assert not torch.equal(out2[:, :, 1:], out[:, :, 1:])


# ------------------------------------------ the CUDA kernel's host side

def _plan_case(lq, lk, causal, slots, window=0):
    label = f"{lq}-{lk}-{causal}-{slots}" + (f"-w{window}" if window else "")
    return pytest.param(lq, lk, causal, slots, window, id=label)


@pytest.mark.parametrize("lq,lk,causal,slots,window", [
    _plan_case(4096, 4096, True, 132),     # the attention-chain task
    _plan_case(4096, 4096, False, 132),
    _plan_case(2048, 2048, True, 132),     # yi-6b's prefill length
    _plan_case(1000, 3000, True, 264),     # queries the last 1000 of 3000
    _plan_case(37, 100, True, 264),
    _plan_case(1, 1, True, 132),
    _plan_case(300, 300, False, 1),        # one slot: no split
    _plan_case(4096, 4096, True, 7),       # fewer slots than query tiles
    _plan_case(8192, 8192, True, 132, 4096),   # zamba2's prefill
    _plan_case(4608, 4608, True, 132, 4096),   # its f32 gate
    _plan_case(8192, 8192, True, 132, 64),
    _plan_case(1000, 1000, True, 132, 1),
    _plan_case(1000, 3000, True, 264, 300),
    _plan_case(300, 700, False, 132, 100),     # full, windowed
    _plan_case(4096, 4096, True, 7, 1000),
])
def test_split_plan_covers_every_live_key_once(lq, lk, causal, slots,
                                               window):
    bq, bk = 128, 64
    plan = split_plan(lq, lk, causal, bq, bk, slots, window)
    n_qt = -(-lq // bq)
    assert len(plan.tiles) == n_qt
    assert sum(count for _, count in plan.tiles) == len(plan.items)
    for t, (first, count) in enumerate(plan.tiles):
        ranges = plan.items[first:first + count]
        assert count >= 1 and all(item[0] == t for item in ranges)
        # consecutive ranges from the first key tile the window of the
        # tile's first row reaches (tile 0 without a window): each tile in
        # exactly one, none wholly before the window
        first_key = max(0, t * bq + lk - lq - window + 1) if window else 0
        assert ranges[0][1] == min(first_key // bk, ranges[-1][2])
        assert all(a[2] == b[1] for a, b in zip(ranges, ranges[1:]))
        assert all(0 < t1 - t0 <= plan.per for _, t0, t1 in ranges) or (
            count == 1 and ranges[0][1] == ranges[0][2])
        # the keys any row of the tile sees, and not one tile past them
        last_pos = min(lq, (t + 1) * bq) - 1 + lk - lq
        live = min(lk, last_pos + 1) if causal else lk
        assert ranges[-1][2] == -(-max(0, live) // bk)
    if n_qt <= slots:                       # one (batch, head): one wave
        assert len(plan.items) <= slots
    if plan.per > 1:                        # and the least split that fits
        walk = [plan.items[f + c - 1][2] - plan.items[f][1]
                for f, c in plan.tiles]
        assert sum(-(-n // (plan.per - 1)) for n in walk) > slots


def test_split_plan_does_not_depend_on_the_batch():
    """A task's plan, so its result, is the same in any batch: the executor
    runs T tasks as B = T, and every (B, H) gives one plan."""
    info = KernelInfo(blocks_per_sm=1, registers=128, spill_bytes=0,
                      smem_bytes=202752, bq=128, bk=64)
    one = plan_for((1, 1, 4096, 128), (1, 1, 4096, 128), True, info, 132)
    for b, h in ((2, 1), (16, 1), (64, 1), (4, 32)):
        assert plan_for((b, h, 4096, 128), (b, 1, 4096, 128), True, info,
                        132) == one
    assert len(one.items) > len(one.tiles)      # the task is split
    # with zamba2's window the same holds, and the window shortens walks
    one_w = plan_for((1, 1, 8192, 64), (1, 1, 8192, 64), True, info, 132,
                     window=4096)
    for b, h in ((2, 32), (8, 1), (1, 32)):
        assert plan_for((b, h, 8192, 64), (b, h, 8192, 64), True, info, 132,
                        window=4096) == one_w
    full = plan_for((1, 1, 8192, 64), (1, 1, 8192, 64), True, info, 132)
    assert one_w != full and one_w.items[-1][2] == full.items[-1][2]


@pytest.mark.parametrize("shape,strides,address,copy", [
    ((2, 4, 64, 128), (32768, 8192, 128, 1), 0, False),     # contiguous
    ((2, 4, 64, 128), (32768, 128, 512, 1), 0, False),      # [B,S,H,D] view
    ((5, 1, 37, 8), (296, 1, 8, 1), 0, False),   # task form, H = 1
    ((1, 1, 16, 8), (128, 7, 8, 1), 16, False),  # 16-byte rows; size-1 dims
    ((1, 2, 16, 37), (1184, 592, 37, 1), 0, True),   # 74-byte rows
    ((1, 1, 16, 1), (16, 16, 1, 1), 0, True),        # D = 1: 2-byte rows
    ((1, 1, 16, 64), (2048, 2048, 128, 2), 0, True),  # column stride 2
    ((1, 2, 16, 64), (2048, 4, 128, 1), 0, True),     # 8-byte head stride
    ((2, 1, 16, 64), (1028, 1028, 64, 1), 0, True),   # batch stride 2056 B
    ((1, 1, 16, 64), (1024, 1024, 64, 1), 8, True),   # base not 16-aligned
])
def test_needs_copy_follows_the_tma_rules(shape, strides, address, copy):
    """bf16 (2 bytes): TMA reads unit column stride, every other stride of
    a dimension longer than 1 a multiple of 16 bytes, a 16-byte base."""
    assert needs_copy(shape, strides, 2, address) is copy


def test_tma_copy_is_readable_and_counted():
    base = torch.from_numpy(_inputs(5, (2, 3, 16, 40))[0]).to(torch.bfloat16)
    t = base[..., 1:38]                                  # D 37, offset base
    assert needs_copy(t.shape, t.stride(), 2, t.data_ptr())
    before = flash_attention.copies
    got = _tma_operand(t)
    assert flash_attention.copies == before + 1
    assert not needs_copy(got.shape, got.stride(), 2, got.data_ptr())
    assert torch.equal(got, t)
    ok = base[..., :32]
    assert _tma_operand(ok) is ok and flash_attention.copies == before + 1


def _rel_rows(got, want):
    """(whole, per row): max|got - want| / max(1, max|want|) over the
    tensor, and the largest over (batch, q head) of max|got - want| /
    max|want| within that head's [Lq, D]."""
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    err = np.abs(got - want)
    whole = err.max() / max(1.0, np.abs(want).max())
    rows = (err.max(axis=(2, 3)) / np.abs(want).max(axis=(2, 3))).max()
    return float(whole), float(rows)


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (1, 4, 1, 256, 256, 64), (1, 2, 2, 200, 600, 128),
    (2, 4, 2, 129, 129, 48), (1, 2, 1, 512, 512, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_rounding_stays_within_the_reference_tolerance(
        b, hq, hkv, lq, lk, d, causal):
    """The bf16 kernel's one extra rounding (P to bf16 before P·V) in plain
    form, against ``mha_ref`` and the JAX package's Pallas kernel
    (interpret mode) on the same bf16 inputs: within the reference's bf16
    tolerance, 2e-2, whole and per (batch, q head)."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(11, (b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)),
        "bfloat16")
    got = mha_bf16_p_ref(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hq, lq, d)
    got = got.float().numpy()
    bq = 128 if lq % 128 == 0 else lq
    bkj = 128 if lk % 128 == 0 else lk
    for want in (mha_ref(tq, tk, tv, causal=causal).float().numpy(),
                 np.asarray(jx_flash_attention(
                     jq, jk, jv, causal=causal, bq=bq, bk=bkj,
                     interpret=True), np.float32)):
        whole, rows = _rel_rows(got, want)
        assert whole <= 2e-2 and rows <= 2e-2, (whole, rows)


def test_bf16_p_rounding_is_the_only_difference_in_f32():
    """In f32 the plain form rounds P and nothing else: with P exact in
    bf16 (every logit equal, so P = 1) it matches ``mha_ref`` to f32
    rounding."""
    (tq, tk, tv), = [_both(_inputs(12, (1, 2, 64, 16), (1, 2, 64, 16),
                                    (1, 2, 64, 16)), "float32")[1]]
    tk = torch.ones_like(tk)
    np.testing.assert_allclose(mha_bf16_p_ref(tq, tk, tv, bk=16).numpy(),
                               mha_ref(tq, tk, tv).numpy(), rtol=2e-6,
                               atol=2e-6)


# ------------------------------------------------- the attention chain PTG

def attn_graph(graph_cls, depth, seq, dim, n_shards):
    """The attention chain of ``multi_device_cases.case_pallas_bodies``:
    task ``l`` self-attends the previous layer's block."""
    g = graph_cls("attnchain", n_shards=n_shards,
                  owner=lambda blk: blk[1] % n_shards,
                  block_shape=(seq, dim))
    g.task_type("src",                    # publish the input as a task
                space=lambda: ((0,),),    # output (communicated blocks
                writes=lambda l: ("x", 0),  # are single-assignment)
                reads=lambda l: [("in", 0)])
    g.task_type("attn",
                space=lambda: ((l,) for l in range(1, depth + 1)),
                writes=lambda l: ("x", l),
                reads=lambda l: [("x", l - 1)] * 3)
    return g


def chain_blocks(depth, seq, dim, **_):
    rng = np.random.default_rng(7)
    blocks = {("in", 0): rng.standard_normal((seq, dim)).astype(np.float32)}
    for l in range(depth + 1):
        blocks[("x", l)] = np.zeros((seq, dim), np.float32)
    return blocks


def _write_reference(path):
    from repro.ptg import Graph as JxGraph

    n = CHAIN["n_shards"]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("shards",))
    prog = attn_graph(JxGraph, **CHAIN).to_program()
    body = {"src": lambda x: x,
            "attn": lambda q, k, v: jx_mha_ref(
                q[None, None], k[None, None], v[None, None],
                causal=True)[0, 0]}
    with mesh:
        out = jax.jit(prog.auto_executor(body, mesh))(
            jnp.asarray(prog.pack(chain_blocks(**CHAIN))))
    unpacked = prog.unpack(np.asarray(out))
    np.savez(path, **{f"x{l}": np.asarray(unpacked[("x", l)])
                      for l in range(CHAIN["depth"] + 1)})


@pytest.fixture(scope="module")
def chain_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_attn_chain") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _port_chain_bodies(attn):
    return {"src": lambda x: x, "attn": attn}


@pytest.mark.parametrize("policy", ["auto", "unrolled", "dense_scan"])
def test_attention_chain_matches_jax_executor(chain_reference, policy):
    prog = attn_graph(Graph, **CHAIN).to_program()
    bodies = _port_chain_bodies(task_attention)
    if policy == "auto":
        ex = prog.auto_executor(bodies, device="cpu")
    else:
        ex = prog.executor(bodies, device="cpu",
                           scan=policy == "dense_scan")
    out = prog.unpack(ex(prog.pack(chain_blocks(**CHAIN), device="cpu")))
    # one body call per wavefront holding an attn task; the dense scan
    # walks every wavefront with padded tables, the src one included
    assert ex.calls["attn"] == CHAIN["depth"] + (policy == "dense_scan")
    for l in range(1, CHAIN["depth"] + 1):
        np.testing.assert_allclose(out[("x", l)].numpy(),
                                   chain_reference[f"x{l}"], rtol=2e-5,
                                   atol=2e-5, err_msg=f"x{l} ({policy})")


def test_attention_chain_matches_mha_ref_bodies():
    """``task_attention`` bodies against per-block ``mha_ref`` bodies of the
    same program (the JAX package's case (b) oracle), bit for bit on the
    CPU, where both are the plain version."""
    prog = attn_graph(Graph, **CHAIN).to_program()
    packed = prog.pack(chain_blocks(**CHAIN), device="cpu")
    got = prog.auto_executor(_port_chain_bodies(task_attention),
                             device="cpu")(packed)
    ref = prog.auto_executor(_port_chain_bodies(
        lambda q, k, v: mha_ref(q[:, None], k[:, None], v[:, None])[:, 0]),
        device="cpu")(packed)
    assert torch.equal(got, ref)


if __name__ == "__main__":
    _write_reference(sys.argv[1])
