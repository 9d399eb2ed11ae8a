"""The port's resident scheduler (``repro_torch.sched``,
``repro_torch.launch.scheduler``) held against the JAX package's on the
CPU: every case of ``tests/test_scheduler.py`` and the scheduler cases of
``tests/test_transport_conformance.py``, each run on the port's
``SchedulerService(device="cpu")`` and on ``repro.sched.SchedulerService``
with the same numpy-seeded blocks.

- Task-Bench results (the port's torch bodies against the JAX package's
  numpy ones: elementwise f32, exact in both), and Cholesky results with
  numpy bodies on both sides, are bit for bit the JAX package's, on
  ``inproc`` and ``multiproc``; each side also equals its own one-shot
  ``Graph.run_host``;
- the port's torch Cholesky bodies agree with the JAX package's jnp bodies
  within 1e-5 (two f32 implementations of potrf/trsm/matmul on 4 x 4
  blocks of O(1) entries, as ``tests/test_torch_host_exec.py``);
- both services give the same per-client ``completed``/``tasks``/
  ``bytes``, the same ``FairPolicy`` order and the same
  ``RecoveryReport.deaths``;
- the port's own contract: results are tensors on the service's device, a
  body whose result lies on another device fails only its submission,
  ``device="cuda"`` without a GPU raises, ``multiproc`` with a CUDA device
  raises ``ValueError``, and ``python -m repro_torch.launch.scheduler
  --device cpu --verify`` prints its verify line.

Hypothesis cases keep the reference's ``max_examples`` and
``deadline=None``.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import repro.core.faults as jx_faults
import repro.ptg as jx_ptg
import repro.sched as jx_sched
from benchmarks import taskbench_scaling as jx_tb
from repro.launch import scheduler as jx_launch
from repro.linalg import cholesky as jx_chol
from repro.sched import namespace as jx_namespace
from repro.sched import service as jx_service
from repro.sched import state as jx_state

import repro_torch.core.faults as pt_faults
import repro_torch.core.messages as pt_messages
import repro_torch.core.comm.inproc as pt_inproc
import repro_torch.ptg as pt_ptg
import repro_torch.sched as pt_sched
from repro_torch import taskbench as pt_tb
from repro_torch.launch import scheduler as pt_launch
from repro_torch.linalg import cholesky as pt_chol
from repro_torch.sched import namespace as pt_namespace
from repro_torch.sched import service as pt_service
from repro_torch.sched import state as pt_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, D, S = 4, 3, 2   # small stencil grid: 12 tasks, 12 blocks, 2 shards
# the port's torch Cholesky bodies against the JAX package's jnp bodies
TOL = 1e-5


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's scheduler, graph front-end, apps and fault plan."""
    name: str
    sched: types.ModuleType
    service: types.ModuleType
    namespace: types.ModuleType
    state: types.ModuleType
    ptg: types.ModuleType
    faults: types.ModuleType
    tb: types.ModuleType
    chol: types.ModuleType
    launch: types.ModuleType
    kw: dict   # the port's device; nothing for the JAX package

    def svc(self, n_shards, **kw):
        return self.sched.SchedulerService(n_shards, **self.kw, **kw)

    def run_host(self, g, blocks, bodies, **kw):
        return g.run_host(blocks, bodies, **self.kw, **kw)


JAX = Side("jax", jx_sched, jx_service, jx_namespace, jx_state, jx_ptg,
           jx_faults, jx_tb, jx_chol, jx_launch, {})
TORCH = Side("torch", pt_sched, pt_service, pt_namespace, pt_state, pt_ptg,
             pt_faults, pt_tb, pt_chol, pt_launch, {"device": "cpu"})
SIDES = (JAX, TORCH)


def host(v) -> np.ndarray:
    """A result block as a numpy array (a port block must be a CPU
    tensor: the service's device)."""
    if isinstance(v, torch.Tensor):
        assert v.device.type == "cpu"
        return v.numpy()
    return np.asarray(v)


def assert_blocks_equal(out, ref):
    assert set(out) == set(ref)
    for blk in ref:
        assert np.array_equal(host(out[blk]), host(ref[blk])), blk


def assert_same(per_side):
    """The port's result equals the JAX package's: nested lists/dicts of
    blocks compare bit for bit, everything else with ``==``."""
    def eq(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                eq(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                eq(x, y)
        elif isinstance(a, (np.ndarray, torch.Tensor)) or hasattr(
                a, "__array__"):
            x, y = host(a), host(b)
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert a == b, (a, b)
    eq(per_side["torch"], per_side["jax"])


def both(case, *args, **kw):
    """Run ``case(side, ...)`` on both packages; the port's result must be
    the JAX package's."""
    got = {side.name: case(side, *args, **kw) for side in SIDES}
    assert_same(got)
    return got


def chained_refs(side, pattern, blocks, m, *, seed=0):
    """Sequential one-shot executions, each seeded with everything the
    previous runs wrote — the oracle for a chained submission stream."""
    bodies = side.tb.taskbench_bodies()
    refs, store = [], dict(blocks)
    for _ in range(m):
        g, _ = side.tb.taskbench_graph(pattern, W, D, S, seed=seed)
        out = side.run_host(g, store, bodies, n_threads=2)
        refs.append(out)
        store.update(out)
    return refs


def client_stats(c) -> dict:
    return {k: c.stats[k] for k in ("submitted", "completed", "failed",
                                    "tasks", "bytes")}


# ------------------------------------------------------------ bit-identity

def _single(side):
    blocks = side.tb.taskbench_blocks(W, D, seed=1)
    (ref,) = chained_refs(side, "stencil", blocks, 1)
    with side.svc(S, timeout=60.0) as svc:
        c = svc.client("alice")
        g, _ = side.tb.taskbench_graph("stencil", W, D, S)
        out = c.submit(g, blocks, side.tb.taskbench_bodies()).result(60.0)
    assert_blocks_equal(out, ref)
    assert c.stats["completed"] == 1 and c.stats["tasks"] == W * D
    return out, client_stats(c)


def test_single_submission_matches_one_shot():
    both(_single)


def _chained(side):
    m = 4
    blocks = side.tb.taskbench_blocks(W, D, seed=2)
    refs = chained_refs(side, "stencil", blocks, m)
    with side.svc(S, timeout=60.0) as svc:
        c = svc.client("alice")
        futs = []
        for j in range(m):
            g, _ = side.tb.taskbench_graph("stencil", W, D, S)
            futs.append(c.submit(g, blocks if j == 0 else {},
                                 side.tb.taskbench_bodies()))
        outs = [f.result(60.0) for f in futs]
    for out, ref in zip(outs, refs):
        assert_blocks_equal(out, ref)
    return outs, client_stats(c)


def test_chained_stream_matches_sequential_one_shots():
    """Submissions 2..m pass no blocks at all: their external reads bind
    to the namespace, i.e. to the previous submission's final writes."""
    both(_chained)


def _map(side):
    with side.svc(S, timeout=60.0) as svc:
        c = svc.client("mapper")
        r = c.map(lambda x: x * 2 + 1, np.arange(9, dtype=np.int64))
        got = [int(v) for v in r.result(60.0)]
    assert got == [2 * i + 1 for i in range(9)]
    return got, client_stats(c)


def test_map_returns_ordered_results():
    both(_map)


def _repeated_map(side):
    with side.svc(S, timeout=60.0) as svc:
        c = svc.client("mapper")
        a = c.map(lambda x: x + 1, np.arange(4, dtype=np.int64)).result(60.0)
        b = c.map(lambda x: x * 10,
                  np.arange(4, 8, dtype=np.int64)).result(60.0)
        third = c.map(lambda x: -x, np.arange(2, dtype=np.int64)).result(60.0)
    got = [[int(v) for v in r] for r in (a, b, third)]
    assert got == [[1, 2, 3, 4], [40, 50, 60, 70], [0, -1]]
    # ephemeral namespaces were dropped after their watermark passed
    assert all(s["ns_live_versions"] == 0 for s in svc.rank_summaries)
    return got, client_stats(c)


def test_repeated_map_uses_fresh_inputs_and_drops_namespaces():
    """Each map call gets its own namespace (a shared one would bind the
    second call's reads to the first call's seeds), dropped once
    resolved."""
    both(_repeated_map)


# ----------------------------------------------------- isolation (property)

def _interleaved(side, pattern, n_clients, m, seed):
    bodies = side.tb.taskbench_bodies()
    blocks = [side.tb.taskbench_blocks(W, D, seed=seed + i)
              for i in range(n_clients)]
    with side.svc(S, timeout=90.0) as svc:
        clients = [svc.client(f"c{i}", weight=float(i + 1))
                   for i in range(n_clients)]
        futs = [[] for _ in range(n_clients)]
        for j in range(m):
            for i, c in enumerate(clients):
                g, _ = side.tb.taskbench_graph(pattern, W, D, S, seed=seed)
                futs[i].append(c.submit(g, blocks[i] if j == 0 else {},
                                        bodies))
        outs = [[f.result(90.0) for f in fs] for fs in futs]
    for i in range(n_clients):
        refs = chained_refs(side, pattern, blocks[i], m, seed=seed)
        for out, ref in zip(outs[i], refs):
            assert_blocks_equal(out, ref)
    return outs, [client_stats(c) for c in clients]


@settings(deadline=None, max_examples=4,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    pattern=st.sampled_from(["stencil", "fft", "tree", "random"]),
    n_clients=st.integers(2, 3),
    m=st.integers(1, 3),
    seed=st.integers(0, 1000),
)
def test_interleaved_client_streams_are_isolated(pattern, n_clients, m, seed):
    """K clients x M chained submissions, round-robin interleaved: each
    client's stream equals its own isolated sequential one-shots."""
    both(_interleaved, pattern, n_clients, m, seed)


# ---------------------------------------------------------------- retirement

def _stream_hwm(side, m):
    blocks = side.tb.taskbench_blocks(W, D, seed=3)
    with side.svc(S, timeout=90.0) as svc:
        c = svc.client("alice")
        for j in range(m):
            g, _ = side.tb.taskbench_graph("stencil", W, D, S)
            c.submit(g, blocks if j == 0 else {},
                     side.tb.taskbench_bodies()).result(90.0)
    return svc.stats()


def _retirement(side):
    s3, s9 = _stream_hwm(side, 3), _stream_hwm(side, 9)
    assert s9["blocks_total"] >= 2 * s3["blocks_total"]
    # slack of one submission's blocks: the watermark that retires sub j
    # races the assimilation of sub j+1
    assert s9["blocks_hwm"] <= s3["blocks_hwm"] + W * D
    assert s9["live_frac"] < s3["live_frac"]
    assert all(r["tasks_live"] == 0 for r in s9["ranks"])
    return [{k: s["clients"]["alice"][k] for k in ("completed", "tasks",
                                                   "bytes")}
            for s in (s3, s9)]


def test_retirement_keeps_live_blocks_flat_across_stream_length():
    """A 3x longer stream materializes ~3x the blocks in total, but the
    high-water mark of live blocks barely moves."""
    both(_retirement)


# ----------------------------------------------------------------- admission

def _single_type_graph(side, name, n_tasks, n_shards=1):
    g = side.ptg.Graph(name, n_shards=n_shards,
                       owner=lambda blk: blk[1] % n_shards)
    g.task_type("t",
                writes=lambda i: ("g", i),
                reads=lambda i: [("g", i)],
                space=side.ptg.IndexSpace(
                    lambda: range(n_tasks),
                    lambda s: [i for i in range(n_tasks)
                               if i % n_shards == s],
                    size=n_tasks))
    return g


def _backpressure(side):
    gate = threading.Event()
    bodies = {"t": lambda x: (gate.wait(60.0), x + 1.0)[1]}
    blocks = {("g", i): np.float64(i) for i in range(2)}
    state = {"admitted": False, "fut": None}
    with side.svc(1, timeout=90.0) as svc:
        c = svc.client("capped", max_inflight_tasks=2)
        f1 = c.submit(_single_type_graph(side, "a", 2), blocks, bodies)

        def second():
            state["fut"] = c.submit(_single_type_graph(side, "b", 2), blocks,
                                    bodies)
            state["admitted"] = True

        t = threading.Thread(target=second, daemon=True)
        t.start()
        time.sleep(0.4)
        # 2 tasks in flight, 2 more would exceed the cap: submit() blocks
        assert not state["admitted"]
        gate.set()
        t.join(60.0)
        assert state["admitted"]
        out1 = f1.result(60.0)
        out2 = state["fut"].result(60.0)
    assert out1[("g", 1)] == 2.0
    assert out2[("g", 1)] == 3.0   # chained through the namespace
    return [out1, out2], client_stats(c)


def test_admission_backpressure_blocks_submit_until_capacity():
    both(_backpressure)


def _admission_timeout(side):
    gate = threading.Event()
    bodies = {"t": lambda x: (gate.wait(60.0), x + 1.0)[1]}
    blocks = {("g", 0): np.float64(0)}
    with side.svc(1, timeout=90.0) as svc:
        c = svc.client("capped", max_inflight_tasks=1)
        f1 = c.submit(_single_type_graph(side, "a", 1), blocks, bodies)
        with pytest.raises(TimeoutError, match="admission blocked"):
            c.submit(_single_type_graph(side, "b", 1), blocks, bodies,
                     timeout=0.2)
        gate.set()
        out = f1.result(60.0)
    return out, client_stats(c)


def test_admission_timeout_raises():
    both(_admission_timeout)


# ------------------------------------------------------------------- failure

def _failure(side):
    def boom(x):
        raise ValueError("boom")

    blocks_a = {("g", i): np.float64(i) for i in range(2)}
    blocks_b = side.tb.taskbench_blocks(W, D, seed=4)
    (ref_b,) = chained_refs(side, "stencil", blocks_b, 1)
    with side.svc(S, timeout=90.0) as svc:
        a, b = svc.client("a"), svc.client("b")
        fa = a.submit(_single_type_graph(side, "bad", 2, S), blocks_a,
                      {"t": boom})
        g, _ = side.tb.taskbench_graph("stencil", W, D, S)
        fb = b.submit(g, blocks_b, side.tb.taskbench_bodies())
        with pytest.raises(side.sched.SubmissionError):
            fa.result(60.0)
        # a's failure poisoned the blocks it never produced: a dependent
        # submission in a's namespace fails loudly instead of hanging
        fdep = a.submit(_single_type_graph(side, "dep", 2, S), {},
                        {"t": lambda x: x + 1.0})
        with pytest.raises(side.sched.SubmissionError, match="upstream"):
            fdep.result(60.0)
        out_b = fb.result(60.0)
        assert_blocks_equal(out_b, ref_b)   # the other tenant is untouched
    assert a.stats["failed"] == 2 and a.stats["completed"] == 0
    assert b.stats["failed"] == 0 and b.stats["completed"] == 1
    return out_b, client_stats(a), client_stats(b)


def test_failed_submission_is_isolated_and_poisons_dependents():
    both(_failure)


def test_body_on_another_device_fails_only_its_submission():
    """A body whose result lies off the service's device fails its own
    submission cleanly (no hang), and the rest of the stream runs on."""
    blocks = pt_tb.taskbench_blocks(W, D, seed=4)
    (ref,) = chained_refs(TORCH, "stencil", blocks, 1)
    off = {t: (lambda *ops: torch.zeros(8, 8, device="meta"))
           for t in pt_tb.taskbench_bodies()}
    with TORCH.svc(S, timeout=60.0) as svc:
        a, b = svc.client("a"), svc.client("b")
        g, _ = pt_tb.taskbench_graph("stencil", W, D, S)
        fa = a.submit(g, blocks, off)
        fb = b.submit(g, blocks, pt_tb.taskbench_bodies())
        with pytest.raises(pt_sched.SubmissionError, match="meta"):
            fa.result(30.0)
        assert_blocks_equal(fb.result(30.0), ref)
        fc = b.submit(g, blocks, pt_tb.taskbench_bodies(), namespace="c")
        assert_blocks_equal(fc.result(30.0), ref)
    assert a.stats["failed"] == 1 and b.stats["completed"] == 2


# ------------------------------------------- resolution finality + memory

def _never_unpoisons(side):
    ns = side.namespace.NamespaceShard(side.state.LiveStats())
    ns.ensure_pending("n", "b", 1)
    ns.poison_sub(1)
    ns.publish("n", "b", 1, torch.tensor(5) if side is TORCH
               else np.int64(5))   # late straggler
    got = []
    ns.bind("n", "b", 2, lambda v, p: got.append((v, p)))
    assert got == [(None, True)]
    return got


def test_publish_never_unpoisons_a_version():
    """A straggler publish after the fail command poisoned the version:
    readers still see the failure — resolution is bus order, not timing."""
    both(_never_unpoisons)


def _after_retirement(side):
    val = (lambda x: torch.tensor(x)) if side is TORCH else np.int64
    stats = side.state.LiveStats()
    ns = side.namespace.NamespaceShard(stats)
    ns.ensure_pending("n", "b", 1)
    ns.ensure_pending("n", "b", 2)
    ns.publish("n", "b", 2, val(7))
    ns.retire_through(2)                    # drops the PENDING (1, 1)
    before = stats.to_dict()
    ns.publish("n", "b", 1, val(3))         # straggler of a retired sub
    ns.publish("n", "b", 2, val(7))         # duplicate re-publish
    assert ns.live_versions() == 1          # only the (2, 1) survivor
    assert stats.to_dict() == before        # no double block_up
    got = []
    ns.bind("n", "b", 3, lambda v, p: got.append((int(v), p)))
    assert got == [(7, False)]
    return got, before


def test_publish_after_retirement_is_discarded():
    both(_after_retirement)


def _bus_trims(side):
    bus = side.service._Bus(2)
    for i in range(10):
        bus.post(("x", i))
    assert bus.read_from(0, 0)[0] == ("x", 0)
    assert len(bus.read_from(10, 0)) == 0   # reader 0 caught up
    assert len(bus._items) == 10            # reader 1 still at 0
    assert [i for _, i in bus.read_from(0, 1)] == list(range(10))
    bus.read_from(10, 1)
    assert len(bus._items) == 0             # both past: prefix trimmed
    bus.post(("x", 10))
    assert bus.read_from(10, 0) == [("x", 10)]   # absolute cursors
    return bus.snapshot()


def test_bus_trims_prefix_all_readers_consumed():
    both(_bus_trims)


def _evicts(side):
    blocks = side.tb.taskbench_blocks(W, D, seed=5)
    with side.svc(S, timeout=60.0) as svc:
        c = svc.client("alice")
        for j in range(3):
            g, _ = side.tb.taskbench_graph("stencil", W, D, S)
            c.submit(g, blocks if j == 0 else {},
                     side.tb.taskbench_bodies()).result(60.0)
    with svc._lock:
        assert svc._subs == {}
    assert svc.stats()["resolved_through"] == 3
    return client_stats(c)


def test_frontdoor_evicts_resolved_records():
    both(_evicts)


# ------------------------------------------------------------------ fairness

def _fair(side):
    def run(seq):
        p = side.sched.FairPolicy()
        return [p.priority_for(c, w) for c, w in seq]

    seq = [("a", 2.0), ("b", 1.0)] * 6
    first = run(seq)
    assert first == run(seq)                      # fully deterministic
    pa, pb = first[0::2], first[1::2]
    assert pa == sorted(pa, reverse=True)
    assert pb == sorted(pb, reverse=True)
    # the weight-2 lane's virtual time advances half as fast
    assert all(x >= y for x, y in zip(pa, pb))
    assert pa[-1] > pb[-1]
    p = side.sched.FairPolicy()
    assert p.priority_for("c", 1.0, 5.0) == pytest.approx(5.0)
    mixed = [("a", 2.0), ("b", 1.0), ("c", 3.0), ("a", 2.0), ("c", 3.0),
             ("b", 1.0), ("b", 1.0), ("a", 2.0)]
    return first, run(mixed), p.snapshot()


def test_fair_policy_is_deterministic_weighted_round_robin():
    """Same priorities, in the same order, as the JAX package's policy."""
    both(_fair)


# ---------------------------------------------------------------- acceptance

def _written_ref(side, make_graph, blocks, bodies):
    # run_host gathers every owned block, read-only inputs included; the
    # future's contract is the submission's writes
    out = side.run_host(make_graph(), blocks, bodies, n_threads=2)
    eager = make_graph().build()
    written = {eager.block_of(k) for k in eager.tasks}
    return {blk: v for blk, v in out.items() if blk in written}


def _mixed_4x8(side, faults=None, timeout=120.0):
    """4 concurrent clients x 8 submissions: all four Task-Bench patterns
    and the Cholesky, numpy Cholesky bodies on both sides."""
    patterns = ("stencil", "fft", "tree", "random")
    tb_blocks = side.tb.taskbench_blocks(W, D, seed=7)
    tb_bodies = side.tb.taskbench_bodies()
    ch_blocks, _ = side.chol.make_spd_blocks(4, 4, seed=7)
    ch_bodies = side.chol.cholesky_bodies_numpy()
    refs = {p: _written_ref(
        side, lambda p=p: side.tb.taskbench_graph(p, W, D, S, seed=7)[0],
        tb_blocks, tb_bodies) for p in patterns}
    refs["cholesky"] = _written_ref(
        side, lambda: side.chol.cholesky_graph(4, 2, 1, 4), ch_blocks,
        ch_bodies)

    results, clients = {}, {}
    kw = {} if faults is None else {"faults": faults}
    with side.svc(S, timeout=timeout, **kw) as svc:
        def run_client(name, weight):
            c = clients[name] = svc.client(name, weight=weight)
            futs = []
            for j in range(8):
                ns = f"{name}/{j}"   # fresh namespace: independent subs
                if j == 7:
                    futs.append(("cholesky", c.submit(
                        side.chol.cholesky_graph(4, 2, 1, 4), ch_blocks,
                        ch_bodies, namespace=ns)))
                else:
                    p = patterns[j % 4]
                    g, _ = side.tb.taskbench_graph(p, W, D, S, seed=7)
                    futs.append((p, c.submit(g, tb_blocks, tb_bodies,
                                             namespace=ns)))
            results[name] = [(kind, f.result(timeout)) for kind, f in futs]

        threads = [threading.Thread(target=run_client,
                                    args=(f"t{i}", float(i + 1)), daemon=True)
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)

    assert sorted(results) == [f"t{i}" for i in range(4)]
    for name, rows in results.items():
        assert len(rows) == 8
        for kind, out in rows:
            assert_blocks_equal(out, refs[kind])
    return svc, {n: results[n] for n in sorted(results)}, \
        {n: client_stats(clients[n]) for n in sorted(clients)}


def _acceptance(side):
    svc, results, stats = _mixed_4x8(side)
    s = svc.stats()
    assert all(r["tasks_live"] == 0 for r in s["ranks"])
    assert all(s["clients"][f"t{i}"]["completed"] == 8 for i in range(4))
    assert s["live_frac"] < 1.0   # retirement did retire
    return results, stats


def test_acceptance_four_clients_eight_mixed_submissions():
    """4 concurrent clients x 8 mixed submissions, every result bit for
    bit its one-shot and the JAX package's, nothing live after the
    drain."""
    both(_acceptance)


def test_torch_cholesky_bodies_match_jnp_bodies_in_a_stream():
    """The port's torch Cholesky bodies (B1's plain version on the CPU for
    syrk/gemm) in a 2-client stream against the JAX package's jnp bodies:
    within 1e-5 per block."""
    from repro_torch.kernels.block_gemm.ops import matmul

    outs = {}
    for side, bodies in ((JAX, jx_chol.cholesky_bodies()),
                         (TORCH, pt_chol.cholesky_bodies(matmul=matmul))):
        blocks, _ = side.chol.make_spd_blocks(4, 4, seed=7)
        with side.svc(S, timeout=60.0) as svc:
            futs = [svc.client(f"c{i}").submit(
                side.chol.cholesky_graph(4, 2, 1, 4), blocks, bodies,
                namespace=f"c{i}") for i in range(2)]
            outs[side.name] = [f.result(60.0) for f in futs]
    for got, want in zip(outs["torch"], outs["jax"]):
        assert set(got) == set(want)
        for blk in want:
            np.testing.assert_allclose(host(got[blk]), np.asarray(want[blk]),
                                       rtol=0, atol=TOL)


# ------------------------------------------------------------ survivability

def _kill_plan(side, rank, at, seed=0):
    return side.faults.FaultPlan(seed=seed, kill={rank: at}, lease=0.4,
                                 heartbeat_every=0.02)


def _chained_under_kill(side, m, at, seed, timeout=90.0):
    blocks = side.tb.taskbench_blocks(W, D, seed=seed)
    refs = chained_refs(side, "stencil", blocks, m, seed=seed)
    with side.svc(S, timeout=timeout,
                  faults=_kill_plan(side, 1, at, seed=seed)) as svc:
        c = svc.client("alice")
        futs = []
        for j in range(m):
            g, _ = side.tb.taskbench_graph("stencil", W, D, S, seed=seed)
            futs.append(c.submit(g, blocks if j == 0 else {},
                                 side.tb.taskbench_bodies()))
        outs = [f.result(timeout) for f in futs]
    for out, ref in zip(outs, refs):
        assert_blocks_equal(out, ref)
    return svc, outs


def _kill_midstream(side):
    svc, outs = _chained_under_kill(side, 4, 8, 11)
    r = svc.recovery_report.to_dict()
    assert r["deaths"] == [1]
    assert r["bus_replayed"] > 0          # adoption replayed the bus
    cap = svc.capacity()
    assert cap["degraded"] and cap["live_ranks"] == S - 1
    assert cap["sched_recover_ms"] is not None
    return outs, r["deaths"]


def test_kill_midstream_chained_results_bit_identical():
    """A chained stream survives a resident rank dying mid-stream (its 8th
    user AM): every future resolves to the sequential one-shot oracle of
    both packages, bit for bit. The JAX package's faulted service is not
    run: at this kill point, on a loaded host, it deadlocks in its
    completion protocol after the adoption (rank 0 alive, rank 1 dead,
    three submissions open) and fails after its 90 s timeout, in about 3
    of 100 runs beside six pytest workers (ROADMAP's reference caveats);
    the port's never did."""
    outs, _ = _kill_midstream(TORCH)
    blocks = jx_tb.taskbench_blocks(W, D, seed=11)
    assert_same({"torch": outs, "jax": chained_refs(JAX, "stencil", blocks,
                                                    4, seed=11)})


@settings(deadline=None, max_examples=6,
          suppress_health_check=[HealthCheck.too_slow])
@given(at=st.integers(1, 60), seed=st.integers(0, 100))
def test_kill_point_sweep_no_hang_any_message_index(at, seed):
    """Kill rank 1 at any user-AM send index of a chained stream (or at
    one never reached): the port's stream drains bit for bit the JAX
    package's sequential one-shots. (The JAX package's faulted service
    runs in no test: adopting after the watermark has passed the adopted
    blocks' last writer, and a killed rank's late report, make it fail or
    hang at some kill points; see ``sched/namespace.py`` and
    ``SchedulerService._rank_done``.)"""
    _, outs = _chained_under_kill(TORCH, 3, at, seed, timeout=60.0)
    blocks = jx_tb.taskbench_blocks(W, D, seed=seed)
    assert_same({"torch": outs, "jax": chained_refs(JAX, "stencil", blocks,
                                                    3, seed=seed)})


def test_acceptance_kill_four_clients_eight_mixed_submissions():
    """The 4 x 8 mixed stream with rank 1 killed at its 40th AM: every
    result bit for bit the JAX package's (fault-free) stream, the same
    per-client accounting, deaths [1]."""
    svc, results, stats = _mixed_4x8(
        TORCH, faults=_kill_plan(TORCH, 1, 40, seed=7), timeout=180.0)
    assert svc.recovery_report.deaths == [1]
    _, jx_results, jx_stats = _mixed_4x8(JAX)
    assert_same({"torch": (results, stats), "jax": (jx_results, jx_stats)})


def _deadline(side):
    gate = threading.Event()
    bodies = {"t": lambda x: (gate.wait(30.0), x + 1.0)[1]}
    blocks = {("g", 0): np.float64(1.0)}
    with side.svc(1, timeout=60.0) as svc:
        c = svc.client("slow")
        f = c.submit(_single_type_graph(side, "stuck", 1), blocks, bodies,
                     namespace="stuck", deadline=0.25)
        with pytest.raises(side.sched.DeadlineExceeded):
            f.result(30.0)
        fdep = c.submit(_single_type_graph(side, "dep", 1), {},
                        {"t": lambda x: x + 1.0}, namespace="stuck")
        with pytest.raises(side.sched.SubmissionError, match="upstream"):
            fdep.result(30.0)
        gate.set()   # release the stuck worker so close() can drain
        ok = c.submit(_single_type_graph(side, "ok", 1), blocks,
                      {"t": lambda x: x + 1.0}, namespace="fresh")
        out = ok.result(30.0)
        assert out[("g", 0)] == 2.0
    assert c.stats["failed"] == 2 and c.stats["completed"] == 1
    return out, client_stats(c)


def test_deadline_sheds_cleanly_and_stream_continues():
    both(_deadline)


def _retry(side):
    calls = []

    def fn(x):
        if not calls:
            calls.append(1)
            time.sleep(1.0)
        return x + 1

    with side.svc(1, timeout=60.0) as svc:
        c = svc.client("retrier")
        fut = c.map(fn, np.arange(3, dtype=np.int64), deadline=0.3,
                    retries=2)
        got = [int(v) for v in fut.result(30.0)]
        assert fut.attempts >= 2
    return got


def test_retry_resubmits_after_deadline_shed():
    both(_retry)


def _degraded(side):
    svc = side.sched.SchedulerService(4, **side.kw)
    caps = [svc._effective_cap(None), svc._effective_cap(8)]
    svc._dead_ranks = {1, 3}
    caps += [svc._effective_cap(8), svc._effective_cap(1)]
    svc._dead_ranks = {1, 2, 3}
    caps.append(svc._effective_cap(8))
    assert caps == [None, 8, 4, 1, 2]
    return caps


def test_degraded_admission_cap_tightens_to_survivors():
    both(_degraded)


def _timeout_snapshot(side):
    gate = threading.Event()
    bodies = {"t": lambda x: (gate.wait(30.0), x + 1.0)[1]}
    blocks = {("g", 0): np.float64(0)}
    with side.svc(1, timeout=60.0) as svc:
        c = svc.client("alice")
        f = c.submit(_single_type_graph(side, "a", 1), blocks, bodies)
        with pytest.raises(TimeoutError) as ei:
            f.result(0.3)
        msg = str(ei.value)
        assert "scheduler snapshot" in msg
        assert "bus:" in msg and "unresolved" in msg and "rank 0:" in msg
        gate.set()
        out = f.result(30.0)
    return out


def test_future_timeout_dumps_protocol_snapshot():
    both(_timeout_snapshot)


def _bus_freeze(side):
    bus = side.service._Bus(3)
    for i in range(6):
        bus.post(("x", i))
    bus.read_from(2, 1)               # the doomed reader got through 2
    bus.freeze(1)
    assert bus.read_from(5, 1) == []  # a zombie read neither advances...
    assert bus.frozen_cursor(1) == 2  # ...nor moves the frozen cursor
    bus.read_from(6, 0)
    bus.read_from(6, 2)               # both survivors fully caught up
    assert bus._base == 2             # trim stopped AT the frozen cursor
    assert [i for _, i in bus.read_range(2, 6)] == [2, 3, 4, 5]
    bus.retire_reader(1, votes_needed=2)
    assert bus._base == 2
    bus.retire_reader(1, votes_needed=2)
    assert bus._base == 6             # last vote: prefix released
    with pytest.raises(RuntimeError, match="trimmed prefix"):
        bus.read_range(2, 6)
    bus2 = side.service._Bus(1)
    bus2.post(("a",), pin=True)
    bus2.post(("b",))
    bus2.read_from(2, 0)
    assert bus2._base == 0            # floor held the prefix
    bus2.set_floor(None)
    bus2.read_from(2, 0)
    assert bus2._base == 2
    return bus.snapshot(), bus2.snapshot()


def test_bus_freeze_pins_trim_until_adoption_votes():
    both(_bus_freeze)


# ------------------------------------- the resident scheduler, cross-process

def _multiproc_mixed(side, n_clients, n_subs):
    """N clients x M mixed submissions into a resident multiproc service
    through the launcher's ``run_stream``; every result bit for bit its
    one-shot inproc oracle."""
    width, depth, nb = 4, 3, 4
    with side.svc(2, n_threads=2, timeout=240.0,
                  transport="multiproc") as svc:
        results = side.launch.run_stream(svc, n_clients, n_subs, width=width,
                                         depth=depth, nb=nb)
    tb_blocks = side.tb.taskbench_blocks(width, depth, seed=7)
    ch_blocks, _ = side.chol.make_spd_blocks(nb, 4, seed=7)
    refs = {}
    for kind in {k for rows in results.values() for k, _ in rows}:
        if kind == "cholesky":
            refs[kind] = side.run_host(
                side.chol.cholesky_graph(nb, 2, 1, 4), ch_blocks,
                side.chol.cholesky_bodies_numpy(), n_threads=2)
        else:
            g, _ = side.tb.taskbench_graph(kind, width, depth, 2, seed=7)
            refs[kind] = side.run_host(g, tb_blocks,
                                       side.tb.taskbench_bodies(),
                                       n_threads=2)
    assert sorted(results) == [f"client{i}" for i in range(n_clients)]
    for name, rows in results.items():
        assert len(rows) == n_subs
        for kind, out in rows:
            assert out is not None
            for blk, v in out.items():
                assert np.array_equal(host(v), host(refs[kind][blk])), \
                    (name, kind, blk)
    return {n: results[n] for n in sorted(results)}, {
        n: {k: c[k] for k in ("completed", "tasks", "bytes")}
        for n, c in svc.stats()["clients"].items()}


def test_multiproc_scheduler_mixed_stream_small():
    both(_multiproc_mixed, 2, 4)


@pytest.mark.skipif(not os.environ.get("REPRO_TRANSPORT_SOAK"),
                    reason="full 4x8 acceptance runs on the CI "
                           "transport-soak leg (REPRO_TRANSPORT_SOAK=1)")
def test_multiproc_scheduler_acceptance_4x8():
    both(_multiproc_mixed, 4, 8)


def _single_task_graph(side, name):
    g = side.ptg.Graph(name, n_shards=1, owner=lambda blk: 0)
    g.task_type("t", writes=lambda i: ("g", i), reads=lambda i: [("g", i)],
                space=side.ptg.IndexSpace(lambda: range(1), lambda s: [0],
                                          size=1))
    return g


def _multiproc_snapshot(side):
    bodies = {"t": lambda x: (time.sleep(1.2), x + 1.0)[1]}
    blocks = {("g", 0): np.float64(0)}
    with side.svc(1, timeout=60.0, transport="multiproc") as svc:
        c = svc.client("alice")
        f = c.submit(_single_task_graph(side, "slow"), blocks, bodies)
        with pytest.raises(TimeoutError) as ei:
            f.result(0.3)
        msg = str(ei.value)
        assert "scheduler snapshot" in msg
        assert "bus:" in msg and "unresolved" in msg
        assert "rank 0:" in msg       # fetched from the child process
        out = f.result(30.0)          # and the submission still completes
    assert float(out[("g", 0)]) == 1.0
    return out


def test_future_timeout_snapshot_crosses_the_process_boundary():
    both(_multiproc_snapshot)


@settings(deadline=None, max_examples=3,
          suppress_health_check=[HealthCheck.too_slow])
@given(at=st.integers(1, 40))
def test_multiproc_kill_point_sweep_stream_bit_identical(at):
    """Kill resident rank 1 at any user-AM send index of a chained
    3-submission stream over ``multiproc``: bit for bit the JAX package's
    sequential one-shots (its faulted service runs once, above)."""
    m = 3
    bodies = pt_tb.taskbench_bodies()
    blocks = pt_tb.taskbench_blocks(W, D, seed=at)
    plan = pt_faults.FaultPlan(seed=at, kill={1: at}, lease=0.4,
                               heartbeat_every=0.02)
    with TORCH.svc(S, timeout=90.0, faults=plan,
                   transport="multiproc") as svc:
        c = svc.client("alice")
        futs = []
        for j in range(m):
            g, _ = pt_tb.taskbench_graph("stencil", W, D, S, seed=at)
            futs.append(c.submit(g, blocks if j == 0 else {}, bodies))
        outs = [f.result(90.0) for f in futs]
    for out, ref in zip(outs, chained_refs(TORCH, "stencil", blocks, m,
                                           seed=at)):
        assert_blocks_equal(out, ref)
    assert_same({"torch": outs, "jax": chained_refs(
        JAX, "stencil", jx_tb.taskbench_blocks(W, D, seed=at), m,
        seed=at)})


def test_a_rank_busy_past_the_lease_is_not_declared_dead(monkeypatch):
    """A resident rank applies every pending bus command before it pumps
    ``progress()`` again, and a submission's assimilation can outlast the
    lease (0.4 s). Rank 1 here spends 1 s on the second submission, after
    the first has run (so rank 0 has heard from it): its heartbeats must
    keep coming, so no rank is declared dead, and the stream is bit for
    bit its one-shots."""
    real, subs = pt_service.ShardRuntime._apply, []

    def slow_apply(self, cmd):
        if self.rank == 1 and cmd[0] == "submit":
            subs.append(cmd)
            if len(subs) == 2:
                time.sleep(1.0)
        return real(self, cmd)

    monkeypatch.setattr(pt_service.ShardRuntime, "_apply", slow_apply)
    blocks = pt_tb.taskbench_blocks(W, D, seed=5)
    plan = pt_faults.FaultPlan(seed=5, lease=0.4, heartbeat_every=0.02)
    with TORCH.svc(S, timeout=60.0, faults=plan) as svc:
        c = svc.client("alice")
        outs = [c.submit(pt_tb.taskbench_graph("stencil", W, D, S,
                                               seed=5)[0],
                         blocks if j == 0 else {},
                         pt_tb.taskbench_bodies()).result(60.0)
                for j in range(2)]
    assert len(subs) == 2 and svc.recovery_report.deaths == []
    for out, ref in zip(outs, chained_refs(TORCH, "stencil", blocks, 2,
                                           seed=5)):
        assert_blocks_equal(out, ref)


@pytest.mark.parametrize("others", ["beating", "paused"])
def test_rank0_away_past_the_lease_declares_no_rank_dead(monkeypatch,
                                                         others):
    """Rank 0's serve loop checks the leases before it reads its inbox
    again. Rank 0 here stays away for 1 s after one ``progress()`` during
    the second submission. ``beating``: the other rank's beats wait unread
    in rank 0's inbox. ``paused``: the whole process pauses (a garbage
    collection, a host that stops scheduling it), so the other rank's
    sends wait until 0.1 s after rank 0 is back. Rank 0's lease clock runs
    only while it reads its inbox, so neither silence is charged to the
    other rank."""
    real_apply = pt_service.ShardRuntime._apply
    real_progress = pt_messages.Communicator.progress
    real_send = pt_inproc.InProcWorld.send
    subs, release = [], []

    def counting_apply(self, cmd):
        if self.rank == 0 and cmd[0] == "submit":
            subs.append(cmd)
        return real_apply(self, cmd)

    def away_progress(self, **kw):
        real_progress(self, **kw)
        if self.rank == 0 and len(subs) == 2 and not release:
            release.append(time.monotonic() + 1.1)
            time.sleep(1.0)

    def paused_send(self, dst, wire):
        if wire.src != 0 and release:
            time.sleep(max(release[0] - time.monotonic(), 0.0))
        return real_send(self, dst, wire)

    monkeypatch.setattr(pt_service.ShardRuntime, "_apply", counting_apply)
    monkeypatch.setattr(pt_messages.Communicator, "progress", away_progress)
    if others == "paused":
        monkeypatch.setattr(pt_inproc.InProcWorld, "send", paused_send)
    blocks = pt_tb.taskbench_blocks(W, D, seed=5)
    plan = pt_faults.FaultPlan(seed=5, lease=0.4, heartbeat_every=0.02)
    with TORCH.svc(S, timeout=60.0, faults=plan) as svc:
        c = svc.client("alice")
        outs = [c.submit(pt_tb.taskbench_graph("stencil", W, D, S,
                                               seed=5)[0],
                         blocks if j == 0 else {},
                         pt_tb.taskbench_bodies()).result(60.0)
                for j in range(2)]
    assert release and svc.recovery_report.deaths == []
    for out, ref in zip(outs, chained_refs(TORCH, "stencil", blocks, 2,
                                           seed=5)):
        assert_blocks_equal(out, ref)


# -------------------------------------------------------- the port's device

def test_results_are_tensors_on_the_service_device():
    blocks = pt_tb.taskbench_blocks(W, D, seed=1)
    with TORCH.svc(S, timeout=60.0) as svc:
        g, _ = pt_tb.taskbench_graph("stencil", W, D, S)
        out = svc.client("a").submit(g, blocks,
                                     pt_tb.taskbench_bodies()).result(60.0)
    assert svc.device == torch.device("cpu")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in out.values())
    # the service stored its own copies: the caller's blocks are untouched
    assert all(np.array_equal(v, pt_tb.taskbench_blocks(W, D, seed=1)[k])
               for k, v in blocks.items())


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_cuda_service_without_a_gpu_raises():
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pt_sched.SchedulerService(2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pt_sched.SchedulerService(2, device="cuda:0")


def test_multiproc_with_a_cuda_device_raises():
    for device in ("cuda", "cuda:0"):
        with pytest.raises(ValueError, match="multiproc"):
            pt_sched.SchedulerService(2, transport="multiproc",
                                      device=device)


def test_public_names_match_the_reference():
    assert pt_sched.__all__ == jx_sched.__all__


def test_launcher_verifies_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.scheduler", "--device",
         "cpu", "--verify", "--clients", "2", "--submissions", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "verify: all 8 submissions bit-identical to one-shot " \
        "executions" in proc.stdout
    assert "(cpu)" in proc.stdout


# ------------------------------------------- the port's recovery repairs

def _sequential_kill(side, at, m=4, seed=5):
    """A chained stream whose submissions go in one at a time (each after
    the one before resolved), with rank 1 killed at its ``at``-th AM: the
    death comes after the watermark has passed earlier submissions."""
    blocks = side.tb.taskbench_blocks(W, D, seed=seed)
    refs = chained_refs(side, "stencil", blocks, m, seed=seed)
    with side.svc(S, timeout=30.0,
                  faults=_kill_plan(side, 1, at, seed=seed)) as svc:
        c = svc.client("alice")
        outs = []
        for j in range(m):
            g, _ = side.tb.taskbench_graph("stencil", W, D, S, seed=seed)
            outs.append(c.submit(g, blocks if j == 0 else {},
                                 side.tb.taskbench_bodies()).result(30.0))
    for out, ref in zip(outs, refs):
        assert_blocks_equal(out, ref)
    return svc, outs


@pytest.mark.parametrize("at", [5, 7])
def test_kill_after_the_watermark_adopts_from_the_checkpoint(at):
    """Rank 1 sends two AMs a submission here, so it dies in submission 3
    (at 5) or 4 (at 7), after the survivor applied the watermark of the
    earlier ones: the adopted shard's blocks must come back from the
    frontdoor's checkpoint although their last writer is retired."""
    svc, outs = _sequential_kill(TORCH, at)
    assert svc.recovery_report.deaths == [1]
    blocks = jx_tb.taskbench_blocks(W, D, seed=5)
    assert_same({"torch": outs,
                 "jax": chained_refs(JAX, "stencil", blocks, 4, seed=5)})


def test_restore_of_a_retired_but_live_version_is_kept():
    """An adopter's timeline for a shard it never hosted is empty: a
    checkpoint row of a retired submission is then the block's live
    version and must be inserted; one superseded within the retired
    prefix is dropped."""
    stats = pt_state.LiveStats()
    ns = pt_namespace.NamespaceShard(stats)
    ns.retire_through(2)
    ns.restore("n", "b", (2, 1), pt_namespace.AVAILABLE, torch.tensor(7))
    got = []
    ns.bind("n", "b", 3, lambda v, p: got.append((int(v), p)))
    assert got == [(7, False)] and stats.blocks_live == 1
    ns.restore("n", "b", (1, 1), pt_namespace.AVAILABLE, torch.tensor(3))
    assert ns.live_versions() == 1 and stats.blocks_live == 1


def test_report_of_a_declared_dead_rank_is_ignored():
    """A killed rank's worker threads may finish a shard after the death
    declaration handed it to an adopter: only the adopter's report
    resolves the submission."""
    svc = pt_sched.SchedulerService(2, device="cpu")
    svc._accepting = True
    c = svc.client("a")
    fut = svc._admit(c, _single_type_graph(TORCH, "t", 2, 2), {}, {},
                     owner_map=None, priority=0.0, namespace="a",
                     ephemeral=False, n_tasks=2, timeout=None)
    svc._rank_done(fut.sub_id, 0, {}, 0, rank=0)
    svc._on_ranks_dead([1], [1])
    svc._rank_done(fut.sub_id, 1, {}, 0, rank=1)     # the killed rank
    assert not fut.done()
    svc._rank_done(fut.sub_id, 1, {}, 0, rank=0)     # its adopter
    assert fut.done() and c.stats["completed"] == 1
