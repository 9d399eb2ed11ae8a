"""The port's host-side lowering equals the JAX package's, array for array
and dict for dict: slot assignment, per-wavefront tables, the dense and
sparse exchange plans, the halo splits, the stacked scan and segment tables
of every policy, ``comm_stats``, ``segments``, ``plan_lowering`` and
``pack``. Case sets: ``tests/multi_device_cases.py``'s lowering_identity
(Cholesky 6 and GEMM 2D, staged or not, on 2x2 shards) and
segmented_identity (Task-Bench patterns x shard counts x depths), plus
Cholesky nb 8 over 4x2 shards."""

import functools

import numpy as np
import pytest

import repro.core.schedule as jx_sched
import repro.linalg.cholesky as jx_chol
import repro.linalg.gemm as jx_gemm
from benchmarks import taskbench_scaling as jx_tb

import repro_torch.core.schedule as pt_sched
import repro_torch.linalg.cholesky as pt_chol
import repro_torch.linalg.gemm as pt_gemm
import repro_torch.taskbench as pt_tb

CASES = {
    "cholesky6_2x2": lambda ch, ge, tb: ch.cholesky_spec(6, 2, 2, 4),
    "gemm4_2x2": lambda ch, ge, tb: ge.gemm_2d_spec(4, 2, 2, 4),
    "gemm4_2x2_staged": lambda ch, ge, tb: ge.gemm_2d_spec(4, 2, 2, 4,
                                                           staged=True),
    "cholesky8_4x2": lambda ch, ge, tb: ch.cholesky_spec(8, 4, 2, 4),
}
for _p in ("stencil", "fft", "tree", "random"):
    for _n, _d in ((2, 7), (4, 5), (4, 13)):
        CASES[f"taskbench_{_p}_s{_n}_d{_d}"] = (
            lambda ch, ge, tb, p=_p, n=_n, d=_d:
            tb.taskbench_spec(p, 8, d, n, 4, fan=2)[0])

POLICIES = [(comm, cover) for comm in ("dense", "sparse", "auto")
            for cover in ("exact", "union")]
PLANS = [dict(), dict(unroll_cap=2), dict(unroll_cap=2, segment_cap=2),
         dict(unroll_cap=2, segment_cap=1), dict(unroll_cap=2, comm="dense"),
         dict(unroll_cap=2, comm="dense", overlap=False),
         dict(unroll_cap=2, comm="sparse", overlap=False),
         dict(unroll_cap=3, density_threshold=0.2)]


@functools.cache
def _programs(name):
    ref = jx_sched.build_block_program(CASES[name](jx_chol, jx_gemm, jx_tb))
    port = pt_sched.build_block_program(CASES[name](pt_chol, pt_gemm, pt_tb))
    return ref, port


def assert_same(got, want, path="root"):
    """Recursive exact equality over dicts, sequences, numpy arrays and
    scalars; arrays must agree in dtype too."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, (jx_sched.SparseRound,)):
        assert isinstance(got, pt_sched.SparseRound), path
        assert got.perm == want.perm, path
        assert_same(got.send, want.send, f"{path}.send")
        assert_same(got.recv, want.recv, f"{path}.recv")
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tables_and_exchange_plans_match_reference(name):
    ref, port = _programs(name)
    assert port.n_slots == ref.n_slots
    assert port.slot_of == ref.slot_of
    assert port.halo_slot == ref.halo_slot
    assert port.types == ref.types and port.arity == ref.arity
    assert_same(port.tables, ref.tables, "tables")
    assert_same(port.exchange, ref.exchange, "exchange")
    assert [p.pair_counts for p in port.patterns] == [
        p.pair_counts for p in ref.patterns]
    assert_same(port.sparse_exchange, ref.sparse_exchange, "sparse_exchange")
    for w in range(len(ref.tables)):
        assert_same(port._split_tables(w), ref._split_tables(w), f"split{w}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_comm_stats_and_segments_match_reference(name):
    ref, port = _programs(name)
    for comm, cover in POLICIES:
        for segmented in (False, True):
            kw = dict(comm=comm, segmented=segmented, cover=cover)
            assert_same(port.comm_stats(**kw), ref.comm_stats(**kw), str(kw))
        assert port.segments(comm, cover=cover) == ref.segments(
            comm, cover=cover), (comm, cover)
        for w in range(len(ref.tables)):
            assert port.lowered_pattern(w, comm) == ref.lowered_pattern(
                w, comm)
            assert port.comm_signature(w, comm) == ref.comm_signature(
                w, comm)
    for kw in PLANS:
        assert port.plan_lowering(**kw) == ref.plan_lowering(**kw), kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_stacked_scan_tables_match_reference(name):
    """The tables the scan lowerings walk, padding included."""
    ref, port = _programs(name)
    assert_same(port._dense_scan_tables(), ref._dense_scan_tables(),
                "dense_scan")
    for comm, cover in POLICIES:
        for overlap in (False, True):
            got = port._segment_tables(comm, 0.5, overlap, cover)
            want = ref._segment_tables(comm, 0.5, overlap, cover)
            assert_same(got, want, f"segments {comm} {cover} {overlap}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_matches_reference(name):
    ref, port = _programs(name)
    rng = np.random.default_rng(len(name))
    b0, b1 = ref.spec.block_shape
    blocks = {blk: rng.standard_normal((b0, b1)).astype(np.float32)
              for blk in ref.slot_of}
    want = ref.pack(blocks)
    got = port.pack(blocks, device="cpu")
    assert got.dtype == pt_sched.torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    unpacked = port.unpack(got)
    assert list(unpacked) == list(ref.unpack(want))
    for blk, arr in blocks.items():
        np.testing.assert_array_equal(unpacked[blk].numpy(), arr)
    # a dict of tensors packs to the same store
    tensors = {blk: pt_sched.torch.from_numpy(arr)
               for blk, arr in blocks.items()}
    np.testing.assert_array_equal(port.pack(tensors, device="cpu").numpy(),
                                  want)
