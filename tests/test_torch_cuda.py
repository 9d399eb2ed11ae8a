"""Tests of the port that need a CUDA GPU: the hand-written kernels (B1
block_gemm, B2 flash_attention, B3 ssd_scan) against their plain versions on
the card, the block executor on the card with B1 and B2 bodies, and one
mamba2 block through B3.
They skip with a reason where there is no GPU. This file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels.block_gemm import (block_gemm, block_gemm_ref,
                                            task_matmul)
from repro_torch.kernels.flash_attention import (flash_attention, mha_ref,
                                                 task_attention)
from repro_torch.kernels.ssd_scan import (ssd, ssd_chunked_ref, ssd_ref,
                                          ssd_scan)
from repro_torch.linalg.cholesky import (assemble_lower, cholesky_executor,
                                         cholesky_program, make_spd_blocks)
from repro_torch.models.mamba2 import mamba2_forward
from repro_torch.models.transformer import init_params
from repro_torch.ptg import Graph

pytestmark = pytest.mark.cuda

# max|kernel - plain| / max(1, max|plain|): the reference's tolerances;
# f32 sums differ only in order, bf16 by one rounding of an f32 sum
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cuda, dtype, T, m, k, n, transposed, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn((T, m, k), generator=gen, device=cuda).to(dtype)
    if transposed:
        return a, torch.randn((T, n, k), generator=gen,
                              device=cuda).to(dtype).mT
    return a, torch.randn((T, k, n), generator=gen, device=cuda).to(dtype)


@pytest.mark.parametrize("T,m,k,n,transposed", [
    (1, 64, 64, 64, False), (1, 128, 96, 64, False), (1, 32, 64, 128, False),
    (1, 256, 128, 256, False), (5, 4, 4, 4, True), (5, 8, 8, 8, True),
    (5, 16, 16, 16, True), (3, 130, 70, 129, True), (2, 512, 512, 512, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_matches_plain(cuda, dtype, T, m, k, n, transposed):
    a, b = _operands(cuda, dtype, T, m, k, n, transposed)
    before = block_gemm.launches
    got = block_gemm(a, b)
    want = block_gemm_ref(a, b)
    torch.cuda.synchronize()
    assert block_gemm.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    err = float((got.float() - want.float()).abs().max()
                / max(1.0, float(want.float().abs().max())))
    assert err <= TOL[dtype]


def test_kernel_result_does_not_depend_on_its_batch(cuda):
    a, b = _operands(cuda, torch.float32, 9, 96, 80, 112, True, seed=1)
    full = block_gemm(a, b)
    for i in range(9):
        assert torch.equal(block_gemm(a[i:i + 1], b[i:i + 1])[0], full[i])


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    a = torch.zeros((2, 4, 4), device=cuda)
    with pytest.raises(TypeError):
        block_gemm(a.double(), a.double())
    with pytest.raises(ValueError):
        block_gemm(a, a.cpu())
    with pytest.raises(ValueError):
        block_gemm(a, torch.zeros((2, 5, 4), device=cuda))


def test_cholesky_executor_runs_the_kernel(cuda):
    nb, b = 6, 16
    prog = cholesky_program(nb, 2, 2, b)
    blocks, a = make_spd_blocks(nb, b, seed=0, device=cuda)
    packed = prog.pack(blocks, device=cuda)
    ex = cholesky_executor(prog, matmul=task_matmul, device=cuda)
    block_gemm.launches = 0
    out = ex(packed)
    torch.cuda.synchronize()
    assert block_gemm.launches == ex.calls["syrk"] + ex.calls["gemm"] > 0
    l = assemble_lower(prog.unpack(out), nb, b)
    plain = cholesky_executor(prog, device=cuda)(packed)
    l_plain = assemble_lower(prog.unpack(plain), nb, b)
    assert float((l - l_plain).abs().max()) <= 1e-5
    resid = torch.linalg.vector_norm(l @ l.mT - a) / torch.linalg.vector_norm(a)
    assert float(resid) <= 1e-6


# ------------------------------------------------------ flash attention (B2)

# B2 and B3 against their plain versions, same measure. B2 takes TOL (the
# reference's 2e-5 / 2e-2: sums and the online softmax's rescaling in
# another order; one bf16 rounding). B3 in f32: the reference's 2e-4 (exp
# of cumulative sums in another order); in bf16 both sides load the same
# bf16 values, compute in f32 and round once: about one bf16 rounding
# (2^-8), so 2e-2.
TOL_SSD = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()
                 / max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", [
    (1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 128, 64), (1, 4, 1, 64, 256, 32),
    (1, 2, 2, 256, 256, 128), (1, 2, 2, 512, 512, 64), (3, 1, 1, 32, 32, 16),
    (1, 2, 1, 37, 100, 48), (2, 4, 2, 100, 100, 80), (1, 1, 1, 1, 1, 8),
    (1, 3, 3, 65, 65, 128),
])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_attention_matches_plain(cuda, dtype, causal, b, hq, hkv, lq,
                                       lk, d):
    gen = torch.Generator(device=cuda).manual_seed(lq * 7 + d)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    want = mha_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel(got, want) <= TOL[dtype]


def test_flash_attention_reads_strided_operands(cuda):
    """q, k, v as views with a padded head dim and swapped axes: the kernel
    reads them through their strides, with no copy."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    base = torch.randn((2, 64, 4, 40), generator=gen, device=cuda)
    q = base[..., :32].transpose(1, 2)             # [2, 4, 64, 32]
    k = torch.randn((2, 64, 2, 32), generator=gen, device=cuda).transpose(1, 2)
    v = torch.randn((2, 2, 64, 32), generator=gen, device=cuda)
    assert not q.is_contiguous() and not k.is_contiguous()
    err = _rel(flash_attention(q, k, v), mha_ref(q, k, v))
    assert err <= TOL[torch.float32]


def test_task_attention_under_the_executor(cuda):
    """The attention-chain PTG (depth 6, seq 32, dim 16, 2 shards) with
    ``task_attention`` bodies: one launch per executor attn call, and the
    result of ``mha_ref`` bodies on the card."""
    depth, seq, dim, n_sh = 6, 32, 16, 2
    g = Graph("attnchain", n_shards=n_sh, owner=lambda blk: blk[1] % n_sh,
              block_shape=(seq, dim))
    g.task_type("src", space=lambda: ((0,),), writes=lambda l: ("x", 0),
                reads=lambda l: [("in", 0)])
    g.task_type("attn", space=lambda: ((l,) for l in range(1, depth + 1)),
                writes=lambda l: ("x", l), reads=lambda l: [("x", l - 1)] * 3)
    prog = g.to_program()
    gen = torch.Generator(device=cuda).manual_seed(7)
    blocks = {("in", 0): torch.randn((seq, dim), generator=gen, device=cuda)}
    for l in range(depth + 1):
        blocks[("x", l)] = torch.zeros((seq, dim), device=cuda)
    packed = prog.pack(blocks, device=cuda)
    ex = prog.auto_executor({"src": lambda x: x, "attn": task_attention},
                            device=cuda)
    flash_attention.launches = 0
    got = ex(packed)
    torch.cuda.synchronize()
    assert flash_attention.launches == ex.calls["attn"] == depth
    plain = prog.auto_executor(
        {"src": lambda x: x,
         "attn": lambda q, k, v: mha_ref(q[:, None], k[:, None],
                                         v[:, None])[:, 0]},
        device=cuda)(packed)
    assert _rel(got, plain) <= TOL[torch.float32]


# ------------------------------------------------------------ SSD scan (B3)

def _ssd_inputs(cuda, dtype, b, l, h, g, p, n, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=cuda)

    x = randn(b, l, h, p).to(dtype)
    dt = (torch.nn.functional.softplus(randn(b, l, h)) * 0.1).to(dtype)
    a = -torch.exp(randn(h) * 0.5)
    bm = (randn(b, l, g, n) * 0.5).to(dtype)
    cm = (randn(b, l, g, n) * 0.5).to(dtype)
    d = torch.full((h,), 0.5, device=cuda)
    return x, dt, a, bm, cm, d


@pytest.mark.parametrize("b,l,h,g,p,n,q", [
    (1, 128, 2, 1, 32, 16, 64), (2, 256, 4, 2, 64, 32, 128),
    (1, 64, 8, 8, 16, 16, 32), (1, 256, 2, 1, 16, 8, 32),
    (1, 256, 4, 1, 64, 128, 128), (2, 96, 4, 2, 80, 24, 48),
    (1, 48, 2, 1, 8, 4, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ssd_scan_matches_plain(cuda, dtype, b, l, h, g, p, n, q):
    x, dt, a, bm, cm, d = _ssd_inputs(cuda, dtype, b, l, h, g, p, n)
    before = ssd_scan.launches
    got = ssd_scan(x, dt, a, bm, cm, d, q_chunk=q)
    want = ssd_chunked_ref(x, dt, a, bm, cm, d, q_chunk=q)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel(got, want) <= TOL_SSD[dtype]
    no_skip = ssd_scan(x, dt, a, bm, cm, None, q_chunk=q)
    assert _rel(no_skip, ssd_chunked_ref(x, dt, a, bm, cm, None,
                                         q_chunk=q)) <= TOL_SSD[dtype]


@pytest.mark.parametrize("l,q", [(100, 32), (200, 128), (7, 4)])
def test_ssd_scan_masks_a_ragged_last_chunk(cuda, l, q):
    """L not a multiple of Q: the kernel masks the last chunk and matches
    the token recurrence (the chunked plain version refuses such L)."""
    x, dt, a, bm, cm, d = _ssd_inputs(cuda, torch.float32, 2, l, 4, 2, 16, 8,
                                      seed=l)
    got = ssd(x, dt, a, bm, cm, d, q_chunk=q)
    assert _rel(got, ssd_ref(x, dt, a, bm, cm, d)) <= TOL_SSD[torch.float32]


def test_ssd_scan_reads_strided_views(cuda):
    """x, B and C as views of one wider projection (the model's layout)."""
    b, l, h, p, g, n = 2, 128, 4, 16, 1, 32
    gen = torch.Generator(device=cuda).manual_seed(3)
    proj = torch.randn((b, l, h * p + 2 * g * n + 5), generator=gen,
                       device=cuda) * 0.5
    x = proj[..., :h * p].unflatten(-1, (h, p))
    bm = proj[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = proj[..., h * p + g * n:h * p + 2 * g * n].unflatten(-1, (g, n))
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=gen,
                                                  device=cuda)) * 0.1
    a = -torch.ones(h, device=cuda)
    assert not x.is_contiguous() and not bm.is_contiguous()
    got = ssd_scan(x, dt, a, bm, cm, None, q_chunk=64)
    want = ssd_chunked_ref(x, dt, a, bm, cm, None, q_chunk=64)
    assert _rel(got, want) <= TOL_SSD[torch.float32]


def test_mamba2_block_runs_the_ssd_kernel(cuda):
    """One reduced mamba2-1.3b block on the card (one B3 launch) against the
    same block on the CPU (the plain version), f32 compute."""
    cfg = reduced(get_config("mamba2-1.3b"), compute_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    layer = {k: v[0] for k, v in params["ssm"]["mamba"].items()}
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    want = mamba2_forward(x, layer, cfg.ssm, cfg.d_model)
    layer_c = {k: v.to(cuda) for k, v in layer.items()}
    before = ssd_scan.launches
    got = mamba2_forward(x.to(cuda), layer_c, cfg.ssm, cfg.d_model)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert _rel(got.cpu(), want) <= TOL_SSD[torch.float32]
