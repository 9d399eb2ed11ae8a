"""The plain version of the port's block GEMM (what the wrapper runs on CPU
tensors) against the JAX package's Pallas kernel in interpret mode and its
jnp oracle, over ``tests/test_kernels.py``'s sweep and the executor's
batched ``.mT`` body form. Inputs come from numpy with a seed and go to both
frameworks. Tolerances are the reference's: f32 2e-5, bf16 2e-2. The CUDA
kernel itself is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_gemm.block_gemm import block_gemm as jx_block_gemm
from repro.kernels.block_gemm.ops import task_matmul as jx_task_matmul
from repro.kernels.block_gemm.ref import block_gemm_ref as jx_ref

from repro_torch.kernels.block_gemm import (block_gemm, block_gemm_ref,
                                            matmul, task_matmul)

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("m,n,k,bm,bn,bk", [
    (64, 64, 64, 32, 32, 32),
    (128, 64, 96, 64, 32, 32),
    (32, 128, 64, 32, 128, 64),
    (256, 256, 128, 128, 128, 64),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_reference_sweep(m, n, k, bm, bn, bk, dtype):
    _, jdt, tdt = DTYPES[dtype]
    a, b = _inputs(0, (m, k), (k, n))
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    want_pallas = np.asarray(jx_block_gemm(ja, jb, bm=bm, bn=bn, bk=bk,
                                           interpret=True), np.float32)
    want_ref = np.asarray(jx_ref(ja, jb), np.float32)
    for got in (block_gemm_ref(ta, tb), block_gemm(ta, tb), matmul(ta, tb)):
        assert got.dtype == tdt and got.shape == (m, n)
        got = got.float().numpy()
        np.testing.assert_allclose(got, want_pallas, **_tol(dtype))
        np.testing.assert_allclose(got, want_ref, **_tol(dtype))


@pytest.mark.parametrize("bsz", [4, 8, 16])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batched_transposed_body_matches_reference(bsz, dtype):
    """The Cholesky body form ``mm(li, lj.mT)`` over a wavefront batch,
    against ``vmap(task_matmul)`` (the fused Pallas launch) of the JAX
    package."""
    _, jdt, tdt = DTYPES[dtype]
    li, lj = _inputs(bsz, (5, bsz, bsz), (5, bsz, bsz))
    want = np.asarray(jax.vmap(jx_task_matmul)(
        jnp.asarray(li).astype(jdt),
        jnp.swapaxes(jnp.asarray(lj).astype(jdt), -1, -2)), np.float32)
    tli, tlj = torch.from_numpy(li).to(tdt), torch.from_numpy(lj).to(tdt)
    got = task_matmul(tli, tlj.mT)
    assert got.dtype == tdt and got.shape == (5, bsz, bsz)
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    a, b = (torch.from_numpy(x) for x in _inputs(3, (3, 8, 8), (3, 8, 8)))
    before = block_gemm.launches
    torch.testing.assert_close(block_gemm(a, b), block_gemm_ref(a, b),
                               rtol=0, atol=0)
    assert block_gemm.launches == before


def test_body_forms_check_their_rank():
    a = torch.zeros(2, 4, 4)
    with pytest.raises(ValueError):
        matmul(a, a)
    with pytest.raises(ValueError):
        task_matmul(a[0], a[0])
