"""Tests of the port that need a CUDA GPU: the hand-written kernels against
their plain versions on the card, and the block executor on the card.
They skip with a reason where there is no GPU. This file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels.block_gemm import (block_gemm, block_gemm_ref,
                                            task_matmul)
from repro_torch.linalg.cholesky import (assemble_lower, cholesky_executor,
                                         cholesky_program, make_spd_blocks)

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
