"""The port's block executor on the CPU:

- every lowering policy (the 11 of ``case_lowering_identity``, the union
  cover, and the auto policy's ladder) gives bit-identical owned and halo
  blocks, on GEMM 2D (staged or not), GEMM 3D, Cholesky and Task-Bench;
- it matches the JAX package's executor with jnp bodies at 2e-5 (run once,
  in a subprocess with 8 forced host devices, which writes an ``.npz``);
- it matches the numpy oracle at the reference's tolerances: 2e-4 for GEMM,
  5e-3 for Cholesky, 1e-5 for Task-Bench.

Run as a script (``python tests/test_torch_linalg.py OUT.npz``) it writes
the JAX package's outputs; the module-scoped fixture does that.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core.schedule as jx_sched
import repro.linalg.cholesky as jx_chol
import repro.linalg.gemm as jx_gemm
from benchmarks import taskbench_scaling as jx_tb

import repro_torch.core.schedule as pt_sched
import repro_torch.linalg.cholesky as pt_chol
import repro_torch.linalg.gemm as pt_gemm
import repro_torch.taskbench as pt_tb
from repro_torch.core.schedule import BlockPTGSpec, build_block_program
from repro_torch.core.discovery import PTG
from repro_torch.kernels.block_gemm.ops import task_matmul

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATTERNS = ("stencil", "fft", "tree", "random")


def _case(name, jax_side):
    """(program, numpy blocks, bodies) of one named case, built with the JAX
    package or the port from the same seeds."""
    ch, ge, tb, sched = ((jx_chol, jx_gemm, jx_tb, jx_sched) if jax_side
                         else (pt_chol, pt_gemm, pt_tb, pt_sched))
    kind, *rest = name.split("_")
    if kind == "gemm2d":
        nb, b = (4, 8) if "small" not in rest else (4, 4)
        spec = ge.gemm_2d_spec(nb, 2, 2, b, staged="staged" in rest)
        return (sched.build_block_program(spec), ge.make_blocks(None, nb, b),
                ge.gemm_bodies())
    if kind == "gemm3d":
        spec = ge.gemm_3d_spec(4, 2, 8)
        return (sched.build_block_program(spec),
                ge.make_blocks(None, 4, 8, with_partials=(0, 1)),
                ge.gemm_bodies())
    if kind == "cholesky":
        nb, pr, pc, b = {"": (5, 2, 2, 8), "6": (6, 2, 2, 4),
                         "8x4x2": (8, 4, 2, 4)}["".join(rest)]
        blocks, _ = ch.make_spd_blocks(nb, b)
        return (sched.build_block_program(ch.cholesky_spec(nb, pr, pc, b)),
                blocks, ch.cholesky_bodies())
    pattern, depth = rest[0], int(rest[1]) if len(rest) > 1 else 6
    spec, _ = tb.taskbench_spec(pattern, 8, depth, 4, 4, fan=2)
    return (sched.build_block_program(spec), tb.taskbench_blocks(8, depth, 4),
            tb.taskbench_bodies())


def _real_slots(prog):
    return ([(s, slot) for (s, slot) in prog.slot_of.values()]
            + [(s, slot) for (s, _), slot in prog.halo_slot.items()])


# ------------------------------------------------ policies, bit for bit

BIT_CASES = ["cholesky_6", "cholesky_8x4x2", "gemm2d_small",
             "gemm2d_small_staged", "gemm3d"] + [
                 f"taskbench_{p}_13" for p in PATTERNS]
VARIANTS = {
    "scan": dict(scan=True),
    "scan_sparse": dict(scan=True, comm="sparse"),
    "scan_auto": dict(scan=True, comm="auto"),
    "scan_auto_overlap": dict(scan=True, comm="auto", overlap=True),
    "scan_sparse_overlap": dict(scan=True, comm="sparse", overlap=True),
    "scan_dense_overlap": dict(scan=True, comm="dense", overlap=True),
    "unrolled_sparse": dict(scan=False, comm="sparse"),
    "unrolled_auto": dict(scan=False, comm="auto"),
    "unrolled_dense_overlap": dict(scan=False, comm="dense", overlap=True),
    "unrolled_sparse_overlap": dict(scan=False, comm="sparse", overlap=True),
    "unrolled_auto_overlap": dict(scan=False, comm="auto", overlap=True),
    "union": dict(scan=True, comm="auto", cover="union"),
    "union_overlap": dict(scan=True, comm="auto", overlap=True,
                          cover="union"),
    "auto": dict(auto=True),
    "auto_cap2": dict(auto=True, unroll_cap=2),
    "auto_cap2_seg1": dict(auto=True, unroll_cap=2, segment_cap=1),
}


@functools.cache
def _port_case(name):
    prog, blocks, bodies = _case(name, jax_side=False)
    packed = prog.pack(blocks, device="cpu")
    ref = prog.executor(bodies, device="cpu", scan=False, comm="dense")(packed)
    return prog, packed, bodies, ref


def _run(prog, bodies, packed, kw):
    kw = dict(kw)
    if kw.pop("auto", False):
        return prog.auto_executor(bodies, device="cpu", **kw)(packed)
    return prog.executor(bodies, device="cpu", **kw)(packed)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", BIT_CASES)
def test_policies_are_bit_identical(name, variant):
    prog, packed, bodies, ref = _port_case(name)
    got = _run(prog, bodies, packed, VARIANTS[variant])
    for s, slot in _real_slots(prog):
        assert torch.equal(got[s, slot], ref[s, slot]), (name, variant,
                                                        s, slot)


def test_auto_policy_reaches_every_lowering():
    """The cases above drive all four plans of ``plan_lowering``."""
    modes = set()
    for name in BIT_CASES:
        prog = _port_case(name)[0]
        for kw in (VARIANTS["auto"], VARIANTS["auto_cap2"],
                   VARIANTS["auto_cap2_seg1"]):
            kw = {k: v for k, v in kw.items() if k != "auto"}
            modes.add(prog.plan_lowering(**kw)["mode"])
            modes.add(prog.plan_lowering(overlap=False, **kw)["mode"])
    assert modes == {"unrolled", "segmented_scan", "union_cover",
                     "dense_scan"}


# --------------------------------------- against the JAX package's executor

REF_CASES = ["gemm2d", "gemm2d_staged", "gemm3d", "cholesky"] + [
    f"taskbench_{p}" for p in PATTERNS]


def _write_reference(path):
    import jax
    import jax.numpy as jnp

    out = {}
    for name in REF_CASES:
        prog, blocks, bodies = _case(name, jax_side=True)
        n = prog.spec.n_shards
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("shards",))
        with mesh:
            res = jax.jit(prog.auto_executor(bodies, mesh))(
                jnp.asarray(prog.pack(blocks)))
        out[name] = np.asarray(res)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference_outputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_reference") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name", REF_CASES)
def test_matches_jax_executor(name, reference_outputs):
    prog, blocks, bodies = _case(name, jax_side=False)
    got = prog.auto_executor(bodies, device="cpu")(
        prog.pack(blocks, device="cpu")).numpy()
    want = reference_outputs[name]
    assert got.shape == want.shape
    for s, slot in _real_slots(prog):
        np.testing.assert_allclose(got[s, slot], want[s, slot],
                                   rtol=2e-5, atol=2e-5,
                                   err_msg=f"{name} shard {s} slot {slot}")


# ----------------------------------------------------- numpy oracles

@pytest.mark.parametrize("matmul", [None, task_matmul],
                         ids=["plain", "task_matmul"])
@pytest.mark.parametrize("name", ["gemm2d", "gemm2d_staged", "gemm3d"])
def test_gemm_matches_oracle(name, matmul):
    prog, blocks, _ = _case(name, jax_side=False)
    ex = pt_gemm.gemm_executor(prog, matmul=matmul, device="cpu")
    out = prog.unpack(ex(prog.pack(blocks, device="cpu")))
    a = pt_gemm.assemble(blocks, "A", 4, 8).numpy()
    bm = pt_gemm.assemble(blocks, "B", 4, 8).numpy()
    c = pt_gemm.assemble(out, "C", 4, 8).numpy()
    np.testing.assert_allclose(c, a @ bm, rtol=2e-4, atol=2e-4)
    assert ex.calls["gemm"] > 0


@pytest.mark.parametrize("matmul", [None, task_matmul],
                         ids=["plain", "task_matmul"])
def test_cholesky_matches_oracle(matmul):
    nb, b = 5, 8
    prog = pt_chol.cholesky_program(nb, 2, 2, b)
    blocks, a = pt_chol.make_spd_blocks(nb, b)
    ex = pt_chol.cholesky_executor(prog, matmul=matmul, device="cpu")
    out = prog.unpack(ex(prog.pack(blocks, device="cpu")))
    l = pt_chol.assemble_lower(out, nb, b).numpy()
    np.testing.assert_allclose(l, np.linalg.cholesky(a), rtol=5e-3,
                               atol=5e-3)
    assert ex.calls["syrk"] > 0 and ex.calls["gemm"] > 0


@pytest.mark.parametrize("pattern", PATTERNS)
def test_taskbench_matches_oracle(pattern):
    spec, deps = pt_tb.taskbench_spec(pattern, 8, 6, 4, 4, fan=2)
    prog = build_block_program(spec)
    blocks = pt_tb.taskbench_blocks(8, 6, 4)
    out = prog.unpack(prog.auto_executor(pt_tb.taskbench_bodies(),
                                         device="cpu")(
        prog.pack(blocks, device="cpu")))
    want = pt_tb.taskbench_oracle(blocks, deps, 8, 6)
    for blk, arr in want.items():
        np.testing.assert_allclose(out[blk].numpy(), arr, rtol=1e-5,
                                   atol=1e-5, err_msg=f"{pattern} {blk}")


def test_cholesky_from_generator_blocks():
    """The on-device form of ``make_spd_blocks`` (here on the CPU): blocks
    are views of the SPD matrix, and the factor reproduces it."""
    nb, b = 4, 8
    gen = torch.Generator().manual_seed(3)
    blocks, a = pt_chol.make_spd_blocks(nb, b, generator=gen)
    assert blocks[("A", 1, 0)].data_ptr() == a[b:2 * b, 0:b].data_ptr()
    prog = pt_chol.cholesky_program(nb, 2, 2, b)
    graph_ex = pt_chol.cholesky_graph(nb, 2, 2, b).executor(
        pt_chol.cholesky_bodies(), device="cpu")
    out = prog.unpack(graph_ex(prog.pack(blocks, device="cpu")))
    l = pt_chol.assemble_lower(out, nb, b)
    resid = torch.linalg.vector_norm(l @ l.mT - a) / torch.linalg.vector_norm(a)
    assert float(resid) < 1e-6


def test_executor_rejects_a_store_of_another_shape():
    prog, blocks, bodies = _case("gemm2d", jax_side=False)
    packed = prog.pack(blocks, device="cpu")
    with pytest.raises(ValueError):
        prog.auto_executor(bodies, device="cpu")(packed[:, :-1])


def test_duplicate_output_slots_are_refused():
    """Two independent tasks of one type writing one block in the same
    wavefront would leave the batched scatter's winner undefined."""
    ptg = PTG(in_deps=lambda k: [], out_deps=lambda k: [],
              mapping=lambda k: 0, type_of=lambda k: "w")
    spec = BlockPTGSpec(ptg=ptg, seeds=["t0", "t1"], n_shards=1,
                        block_shape=(2, 2), block_of=lambda k: "x",
                        operands=lambda k: ["x"], owner=lambda blk: 0)
    with pytest.raises(ValueError, match="duplicate output slots"):
        build_block_program(spec)


if __name__ == "__main__":
    _write_reference(sys.argv[1])
