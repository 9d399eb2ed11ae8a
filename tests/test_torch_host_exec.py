"""The port's host lowering (``linalg/host_exec.py``, ``Graph.to_taskflow``,
``Graph.run_host``) held against the JAX package's on the CPU:

- Cholesky (nb 4, b 4, 2 x 2), GEMM 2D and every Task-Bench pattern give
  the JAX package's blocks from the same numpy-seeded inputs: bit for bit
  where both sides run the same numpy arithmetic (on ``inproc`` and
  ``multiproc``), within 1e-5 where the port's torch CPU bodies meet the
  JAX package's jnp bodies;
- both runtimes send the same number of AMs per rank pair, and
  ``to_taskflow`` wires each rank the same way (indegrees, tasks run, AMs
  received with or without a payload);
- the port's host run matches the port's compiled block executor (the
  counterpart of ``case_cholesky_host_matches_compiled``);
- a faulted run is bit for bit the fault-free one, with the JAX package's
  ``rederived_frac``;
- the store stays on its device: blocks are copied once, bodies that
  return another device raise, ``device="cuda"`` without a GPU raises.
"""

import numpy as np
import pytest
import torch

from repro.core import run_ranks as jx_run_ranks
from repro.core.faults import FaultPlan as JxFaultPlan
from repro.linalg import cholesky as jx_chol
from repro.linalg import gemm as jx_gemm
from benchmarks import taskbench_scaling as jx_tb

from repro_torch.core import FaultPlan, payload_stats, run_ranks
from repro_torch.linalg import cholesky as pt_chol
from repro_torch.linalg import gemm as pt_gemm
from repro_torch.linalg.host_exec import as_block, run_host_ptg
from repro_torch import taskbench as pt_tb

PATTERNS = ("stencil", "fft", "tree", "random")
# the port's torch CPU bodies against the JAX package's jnp bodies: two f32
# implementations of potrf/trsm/matmul on 4 x 4 blocks of O(1) entries
TOL = 1e-5


def numpy_bodies(bodies):
    """Run ``bodies`` (written with ``@``, ``+``, ``-``) on numpy views of
    CPU tensor blocks: the same numpy arithmetic the JAX package's host
    runtime runs on its numpy stores."""
    return {t: (lambda fn: lambda *ops: torch.from_numpy(np.asarray(
        fn(*(o.numpy() for o in ops)))))(fn) for t, fn in bodies.items()}


def _case(app, jax_side, pattern="stencil"):
    """(graph, numpy blocks, numpy bodies, torch/jnp bodies) of one app."""
    if app == "cholesky":
        mod = jx_chol if jax_side else pt_chol
        blocks, _ = mod.make_spd_blocks(4, 4, seed=3)
        np_bodies = mod.cholesky_bodies_numpy()
        return (mod.cholesky_graph(4, 2, 2, 4), blocks, np_bodies,
                mod.cholesky_bodies())
    if app == "gemm":
        mod = jx_gemm if jax_side else pt_gemm
        bodies = mod.gemm_bodies()
        return (mod.gemm_2d_graph(4, 2, 2, 4), mod.make_blocks(None, 4, 4),
                bodies if jax_side else numpy_bodies(bodies), bodies)
    mod = jx_tb if jax_side else pt_tb
    g, _ = mod.taskbench_graph(pattern, 8, 4, 4, 4, fan=2)
    bodies = mod.taskbench_bodies()
    return (g, mod.taskbench_blocks(8, 4, 4), bodies if jax_side
            else numpy_bodies(bodies), bodies)


CASES = ([("cholesky", None), ("gemm", None)]
         + [("taskbench", p) for p in PATTERNS])
IDS = [a if p is None else f"{a}-{p}" for a, p in CASES]


def _equal(out, ref):
    assert out.keys() == ref.keys()
    for blk in ref:
        assert out[blk].device.type == "cpu"
        assert np.array_equal(out[blk].numpy(), np.asarray(ref[blk])), blk


@pytest.mark.parametrize("app,pattern", CASES, ids=IDS)
def test_numpy_bodies_bit_identical_to_reference(app, pattern):
    g, blocks, np_bodies, _ = _case(app, False, pattern or "stencil")
    jg, _, jx_np_bodies, _ = _case(app, True, pattern or "stencil")
    ref = jg.run_host(blocks, jx_np_bodies)
    _equal(g.run_host(blocks, np_bodies, device="cpu"), ref)


@pytest.mark.parametrize("app", ["cholesky", "gemm"])
def test_numpy_bodies_bit_identical_on_multiproc(app):
    g, blocks, np_bodies, _ = _case(app, False)
    jg, _, jx_np_bodies, _ = _case(app, True)
    ref = jg.run_host(blocks, jx_np_bodies, transport="multiproc")
    _equal(g.run_host(blocks, np_bodies, device="cpu",
                      transport="multiproc"), ref)


@pytest.mark.parametrize("app,pattern", CASES, ids=IDS)
def test_torch_bodies_match_reference_bodies(app, pattern):
    """The port's torch bodies on CPU tensor stores against the JAX
    package's own bodies (jnp potrf/trsm for Cholesky) on numpy stores."""
    g, blocks, _, bodies = _case(app, False, pattern or "stencil")
    jg, _, _, jx_bodies = _case(app, True, pattern or "stencil")
    ref = jg.run_host(blocks, jx_bodies)
    out = g.run_host(blocks, bodies, device="cpu")
    assert out.keys() == ref.keys()
    for blk in ref:
        want = np.asarray(ref[blk])
        err = np.abs(out[blk].numpy() - want).max() / max(1.0, np.abs(
            want).max())
        assert err <= TOL, (blk, err)


@pytest.mark.parametrize("app,pattern", CASES, ids=IDS)
def test_to_taskflow_wiring_and_am_counts_match_reference(app, pattern):
    """Per rank: the same indegree for every owned task, the same tasks
    run, the same AMs received (consumer, block, payload or not) and the
    same count of AMs sent to each rank as the JAX package's wiring."""

    def wiring(graph, blocks, bodies, ranks, to_store):
        spec = graph.to_block_spec()
        n = spec.n_shards

        def main(ctx):
            store = {blk: to_store(a) for blk, a in blocks.items()
                     if spec.owner(blk) % n == ctx.rank}
            tf, seed = graph.to_taskflow(ctx, store, bodies)
            owned = sorted((k for v in spec.views for k in v.tasks
                            if spec.ptg.mapping(k) % n == ctx.rank), key=repr)
            indeg = {k: tf._indegree(k) for k in owned}
            ran, got = [], []
            run, on_am = tf._task, ctx.comm._registry[0]["fn"]
            tf.set_task(lambda k: (ran.append(k), run(k)))
            ctx.comm._registry[0]["fn"] = lambda d, blk, p: (
                got.append((d, blk, p is not None)), on_am(d, blk, p))
            seed()
            ctx.tp.join()
            return (indeg, sorted(ran, key=repr), sorted(got, key=repr),
                    list(ctx.comm.queued_to))
        return ranks(n, main)

    g, blocks, np_bodies, _ = _case(app, False, pattern or "stencil")
    jg, _, jx_np_bodies, _ = _case(app, True, pattern or "stencil")
    payload_stats.reset()
    port = wiring(g, blocks, np_bodies, run_ranks,
                  lambda a: torch.as_tensor(a).clone())
    ref = wiring(jg, blocks, jx_np_bodies, jx_run_ranks, np.array)
    assert port == ref
    assert payload_stats.pickled == 0
    sent = {(s, d): n for s, r in enumerate(port)
            for d, n in enumerate(r[3]) if n}
    assert {k: v[0] for k, v in payload_stats.pairs.items()} == sent
    assert payload_stats.copied == sum(p for r in port for *_, p in r[2])


@pytest.mark.parametrize("nb,pr,pc,b", [(4, 2, 2, 4), (5, 2, 2, 8),
                                        (6, 4, 2, 4)])
def test_cholesky_host_matches_compiled(nb, pr, pc, b):
    """The host runtime and the compiled block executor on one program,
    same torch bodies, on the CPU."""
    blocks, a = pt_chol.make_spd_blocks(nb, b)
    spec = pt_chol.cholesky_spec(nb, pr, pc, b)
    host = run_host_ptg(spec, blocks, pt_chol.cholesky_bodies(),
                        device="cpu")
    prog = pt_chol.cholesky_program(nb, pr, pc, b)
    comp = prog.unpack(pt_chol.cholesky_executor(prog, device="cpu")(
        prog.pack(blocks, device="cpu")))
    for key, arr in host.items():
        if key[0] == "L":
            torch.testing.assert_close(arr, comp[key], rtol=1e-5, atol=1e-5)
    low = pt_chol.assemble_lower(host, nb, b)
    torch.testing.assert_close(low @ low.mT, torch.from_numpy(a), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("bodies", ["torch", "numpy"])
def test_faulted_run_bit_identical_to_fault_free(bodies):
    nb, b, pr, pc = 5, 4, 2, 2
    g = pt_chol.cholesky_graph(nb, pr, pc, b)
    blocks, _ = pt_chol.make_spd_blocks(nb, b, seed=1)
    fns = (pt_chol.cholesky_bodies() if bodies == "torch"
           else pt_chol.cholesky_bodies_numpy())
    ref = g.run_host(blocks, fns, device="cpu")
    kw = dict(seed=2, drop=0.1, duplicate=0.1, kill={2: 2})
    out, report = g.run_host(blocks, fns, faults=FaultPlan(**kw),
                             device="cpu", timeout=120.0)
    assert out.keys() == ref.keys()
    for blk in ref:
        assert torch.equal(out[blk], ref[blk]), blk
    assert report.deaths == [2] and report.reexecuted_tasks > 0
    _, jx_report = jx_chol.cholesky_graph(nb, pr, pc, b).run_host(
        blocks, jx_chol.cholesky_bodies_numpy(), faults=JxFaultPlan(**kw),
        timeout=120.0)
    assert report.rederived_frac == jx_report.rederived_frac


def test_store_copies_blocks_once_and_keeps_their_device():
    """The caller's blocks are copied into the store (never aliased), the
    result lies on the store's device, and the caller's blocks are
    untouched."""
    blocks = {k: torch.from_numpy(v)
              for k, v in pt_tb.taskbench_blocks(4, 3, 4).items()}
    before = {k: v.clone() for k, v in blocks.items()}
    g, _ = pt_tb.taskbench_graph("stencil", 4, 3, 2, 4)
    out = g.run_host(blocks, {t: (lambda fn: lambda *o: fn(*o).mul_(1.0))(fn)
                              for t, fn in pt_tb.taskbench_bodies().items()},
                     device="cpu")
    for k in blocks:
        assert torch.equal(blocks[k], before[k])
        assert out[k].data_ptr() != blocks[k].data_ptr()


def test_body_on_another_device_raises():
    with pytest.raises(ValueError, match="store lives on"):
        as_block(torch.zeros(2, device="meta"), torch.device("cpu"))
    g, _ = pt_tb.taskbench_graph("stencil", 4, 2, 2, 4)
    bad = {t: (lambda *ops: torch.zeros(4, 4, device="meta"))
           for t in pt_tb.taskbench_bodies()}
    with pytest.raises(RuntimeError, match="store lives on"):
        g.run_host(pt_tb.taskbench_blocks(4, 2, 4), bad, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_cuda_store_without_a_gpu_raises():
    g = pt_chol.cholesky_graph(2, 2, 1, 4)
    blocks, _ = pt_chol.make_spd_blocks(2, 4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        g.run_host(blocks, pt_chol.cholesky_bodies())
