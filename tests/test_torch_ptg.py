"""The port's PTG front-end derives exactly what the JAX package's does:
``Graph.build()`` (edges, operands, blocks, types, mapping, seeds), every
shard's lazy ``derive_local`` view (with and without an owner override),
and the discovered schedule, for GEMM 2D/3D, Cholesky and the four
Task-Bench patterns. Host-side structures must be equal, not close."""

import pytest

import repro.linalg.cholesky as jx_chol
import repro.linalg.gemm as jx_gemm
from benchmarks import taskbench_scaling as jx_tb

import repro_torch.linalg.cholesky as pt_chol
import repro_torch.linalg.gemm as pt_gemm
import repro_torch.taskbench as pt_tb

GRAPHS = {
    "gemm2d": lambda m: m.gemm_2d_graph(4, 2, 2, 4),
    "gemm2d_staged": lambda m: m.gemm_2d_graph(4, 2, 2, 4, staged=True),
    "gemm3d": lambda m: m.gemm_3d_graph(4, 2, 4),
    "cholesky": lambda m: m.cholesky_graph(6, 2, 2, 4),
    "cholesky_4x2": lambda m: m.cholesky_graph(8, 4, 2, 4),
}
for _pattern in ("stencil", "fft", "tree", "random"):
    GRAPHS[f"taskbench_{_pattern}"] = (
        lambda m, p=_pattern: m.taskbench_graph(p, 8, 6, 4, 4, fan=2)[0])

_MODULES = {"gemm": (jx_gemm, pt_gemm), "cholesky": (jx_chol, pt_chol),
            "taskbench": (jx_tb, pt_tb)}


def _pair(name):
    jx, pt = _MODULES[name.split("2d")[0].split("3d")[0].split("_")[0]]
    return GRAPHS[name](jx), GRAPHS[name](pt)


def _graph_state(g):
    g.build()
    return {
        "tasks": list(g.tasks), "seeds": list(g.seeds),
        "in": {k: list(g.in_deps(k)) for k in g.tasks},
        "out": {k: list(g.out_deps(k)) for k in g.tasks},
        "operands": {k: list(g.operands(k)) for k in g.tasks},
        "block": {k: g.block_of(k) for k in g.tasks},
        "type": {k: g.type_of(k) for k in g.tasks},
        "map": {k: g.mapping(k) for k in g.tasks},
    }


def _view_state(v):
    return {
        "shard": v.shard, "tasks": v.tasks, "seeds": v.seeds, "pos": v.pos,
        "stats": v.stats, "in": v._in, "out": v._out,
        "operands": v._operands, "block": v._block, "type": v._type,
        "map": v._map, "ext": v._ext, "payload": v._payload,
        "final_writes": v.final_writes,
    }


def _schedule_state(sched):
    return {
        "wavefronts": [s.wavefronts for s in sched.shards],
        "expanded": [s.expanded for s in sched.shards],
        "level_of": sched.level_of,
        "messages": {lvl: {pair: [(m.src, m.dst, m.src_task, m.dst_task,
                                   m.level) for m in msgs]
                           for pair, msgs in groups.items()}
                     for lvl, groups in sched.messages.items()},
    }


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_matches_reference(name):
    ref, port = _pair(name)
    assert _graph_state(port) == _graph_state(ref)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_local_views_match_reference(name):
    ref, port = _pair(name)
    for s in range(ref.n_shards):
        assert _view_state(port.derive_local(s)) == _view_state(
            ref.derive_local(s)), f"shard {s}"


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_local_views_under_owner_override_match_reference(name):
    """An owner override defeats the strip enumeration: derive_local falls
    back to the full scan, which must agree too."""
    ref, port = _pair(name)
    n = ref.n_shards
    for s in range(n):
        got = port.derive_local(s, lambda blk: (port.owner(blk) + 1) % n)
        want = ref.derive_local(s, lambda blk: (ref.owner(blk) + 1) % n)
        assert _view_state(got) == _view_state(want), f"shard {s}"


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_schedules_match_reference(name):
    ref, port = _pair(name)
    assert _schedule_state(port.to_schedule()) == _schedule_state(
        ref.to_schedule())
    assert _schedule_state(port.to_schedule(lazy=False)) == _schedule_state(
        ref.to_schedule(lazy=False))
