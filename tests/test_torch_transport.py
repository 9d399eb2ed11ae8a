"""The port's pluggable transports (``inproc``, ``multiproc``): the port
version of ``tests/test_transport_conformance.py``, with tensor payloads.

Every registered backend presents one contract to the runtime — per-pair
FIFO, exactly-once under loss and duplication, the same failure surfacing,
the same channel lifecycle — and the Task-Bench sweep and the blocked
Cholesky give the same blocks whether the ranks are threads or forked
processes, and the same blocks as the JAX package's host runtime on both
(same numpy arithmetic on both sides, so bit for bit). ``multiproc``
carries host data only: a CUDA payload raises rather than passing through
the host (checked here with the device test faked, since this machine has
no GPU).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import repro.core.comm as jx_comm
from repro.linalg import cholesky as jx_chol
from benchmarks import taskbench_scaling as jx_tb

import repro_torch.core.messages as messages
from repro_torch.core import FaultPlan, run_ranks
from repro_torch.core.comm import (CommClosedError, Wire, backend_names,
                                   get_backend)
from repro_torch.linalg import cholesky as pt_chol
from repro_torch import taskbench as pt_tb

BACKENDS = sorted(backend_names())
PATTERNS = ("stencil", "fft", "tree", "random")
LEGS = [pytest.param(b, p, id=b if not p else f"{b}-lossdup")
        for b in BACKENDS for p in (0.0, 0.15)]


def _plan(p: float, seed: int = 5, **kw) -> FaultPlan:
    return FaultPlan(seed=seed, drop=p, duplicate=p, **kw)


# ------------------------------------------------------------- the registry

def test_registry_matches_the_reference():
    assert backend_names() == jx_comm.backend_names()
    assert {"inproc", "multiproc"} <= set(backend_names())
    assert get_backend("inproc").carries_device_tensors
    assert not get_backend("multiproc").carries_device_tensors


def test_registry_unknown_backend_fails_loudly():
    with pytest.raises(KeyError, match="carrier-pigeon"):
        get_backend("carrier-pigeon")
    with pytest.raises(KeyError, match="inproc"):
        get_backend("carrier-pigeon")


def test_registry_env_var_is_the_default(monkeypatch):
    monkeypatch.delenv("REPRO_TRANSPORT", raising=False)
    assert get_backend(None).name == "inproc"
    monkeypatch.setenv("REPRO_TRANSPORT", "multiproc")
    assert get_backend(None).name == "multiproc"
    assert get_backend("inproc").name == "inproc"


# ------------------------------------------- channel-level contract (Comm)

@pytest.mark.parametrize("backend_name", BACKENDS)
def test_channel_echo_roundtrip_and_clean_listener_shutdown(backend_name):
    """Payloads round-trip unchanged (a Wire carrying a tensor view payload
    and tensor args included), and a stopped listener serves nothing."""
    backend = get_backend(backend_name)
    served = threading.Event()

    def echo(ch):
        served.set()
        try:
            while True:
                ch.write(ch.read(timeout=5.0))
        except (CommClosedError, TimeoutError):
            ch.close()

    lis = backend.listener(echo)
    lis.start()
    try:
        ch = backend.connector().connect(lis.address)
        for i in range(5):
            ch.write(("ping", i))
            assert ch.read(timeout=5.0) == ("ping", i)
        wire = Wire(kind="am", src=3, am_id=1, blob=b"\x00payload",
                    raw=torch.arange(6, dtype=torch.float32), seq=9,
                    tensors=(torch.ones(2, 3).mT,))
        ch.write(wire)
        back = ch.read(timeout=5.0)
        assert (back.kind, back.src, back.am_id, back.blob, back.seq) == \
            ("am", 3, 1, b"\x00payload", 9)
        assert torch.equal(back.raw, wire.raw)
        assert torch.equal(back.tensors[0], wire.tensors[0])
        ch.close()
        assert ch.closed
    finally:
        lis.stop()
    served.clear()
    try:
        orphan = backend.connector().connect(lis.address, timeout=0.5)
    except CommClosedError:
        return
    time.sleep(0.2)
    assert not served.is_set()
    orphan.close()


# ------------------------------------------- world-level delivery semantics

@pytest.mark.parametrize("transport,p", LEGS)
def test_per_pair_fifo_exactly_once(transport, p):
    n, m = 3, 10

    def main(ctx):
        got = {}
        am = ctx.comm.make_active_msg(
            lambda src, t: got.setdefault(src, []).append(int(t)))
        for dst in range(ctx.n_ranks):
            if dst != ctx.rank:
                for i in range(m):
                    am.send(dst, ctx.rank, torch.tensor(i))
        ctx.tp.join()
        return got

    res, report = run_ranks(n, main, faults=_plan(p), timeout=90.0,
                            transport=transport)
    for r, got in enumerate(res):
        assert sorted(got) == [s for s in range(n) if s != r]
        for src, seqs in got.items():
            if p:
                assert sorted(seqs) == list(range(m)), (r, src, seqs)
            else:
                assert seqs == list(range(m)), (r, src, seqs)
    if p:
        assert report.injected_drops + report.injected_dups > 0


@pytest.mark.parametrize("backend_name", BACKENDS)
@pytest.mark.parametrize("drop,dup", [(0.0, 0.5), (0.3, 0.0)],
                         ids=["dup", "drop"])
def test_lossy_delivery_exactly_once(backend_name, drop, dup):
    plan = FaultPlan(seed=3 if dup else 7, drop=drop, duplicate=dup)

    def main(ctx):
        received = []
        am = ctx.comm.make_active_msg(lambda i: received.append(i))
        if ctx.rank == 0:
            for i in range(30):
                am.send(1, i)
        ctx.tp.join()
        return received

    res, report = run_ranks(2, main, faults=plan, timeout=90.0,
                            transport=backend_name)
    if dup:
        assert res[1] == list(range(30))
        assert report.injected_dups > 0 and report.dup_suppressed > 0
    else:
        assert sorted(res[1]) == list(range(30))
        assert report.injected_drops > 0 and report.retries > 0


# --------------------------------------------------------- failure surfacing

@pytest.mark.parametrize("backend_name", BACKENDS)
def test_rank_kill_surfaces_death_and_survivors_drain(backend_name):
    plan = FaultPlan(seed=11, drop=0.05, duplicate=0.05, kill={1: 3})

    def main(ctx):
        received = []
        am = ctx.comm.make_active_msg(lambda i: received.append(i))
        if ctx.rank != 0:
            for i in range(10):
                am.send(0, ctx.rank * 100 + i)
        ctx.tp.join()
        return received

    res, report = run_ranks(3, main, faults=plan, timeout=90.0,
                            transport=backend_name)
    assert res[1] is None
    assert report.deaths == [1]
    got = sorted(res[0])
    assert [x for x in got if x >= 200] == [200 + i for i in range(10)]
    from_dead = [x for x in got if x < 200]
    assert set(from_dead) <= {100, 101}
    assert len(from_dead) == len(set(from_dead))


@pytest.mark.parametrize("backend_name", BACKENDS)
def test_rank_error_propagates_with_remote_traceback(backend_name):
    def main(ctx):
        if ctx.rank == 1:
            raise ValueError("boom-evidence-42")
        ctx.tp.join()

    with pytest.raises(RuntimeError, match="rank 1 failed") as ei:
        run_ranks(2, main, faults=_plan(0.0), timeout=60.0,
                  transport=backend_name)
    assert "boom-evidence-42" in str(ei.value)
    assert "ValueError" in str(ei.value)


def test_multiproc_ranks_are_real_processes_and_pickle_host_tensors():
    """Ranks are OS processes; tensor payloads cross them pickled (and are
    counted as pickled), CPU tensors only."""
    def main(ctx):
        got = []
        am = ctx.comm.make_active_msg(lambda t: got.append(t))
        if ctx.rank == 0:
            am.send(1, torch.arange(4.0))
        ctx.tp.join()
        return os.getpid(), got, messages.payload_stats.pickled

    res, _ = run_ranks(3, main, faults=_plan(0.0), timeout=60.0,
                       transport="multiproc")
    pids = [pid for pid, _, _ in res]
    assert len(set(pids)) == 3 and os.getpid() not in pids
    assert torch.equal(res[1][1][0], torch.arange(4.0))
    assert res[0][2] == 1      # rank 0's process pickled one tensor


def test_multiproc_refuses_a_device_payload(monkeypatch):
    """A tensor that is not on the host (faked: the device test says so)
    raises ValueError at send under multiproc, instead of being moved to
    the host; the same send under inproc stays a device copy."""
    monkeypatch.setattr(messages, "on_host", lambda t: False)

    def main(ctx):
        am = ctx.comm.make_active_msg(lambda t: None)
        if ctx.rank == 0:
            am.send(1, torch.zeros(3))
        ctx.tp.join()
        return True

    with pytest.raises(RuntimeError, match="rank 0 failed") as ei:
        run_ranks(2, main, timeout=60.0, transport="multiproc")
    assert "ValueError" in str(ei.value)
    assert "host data only" in str(ei.value)
    messages.payload_stats.reset()
    assert run_ranks(2, main, timeout=60.0, transport="inproc") == [True,
                                                                    True]
    assert messages.payload_stats.copied == 1
    assert messages.payload_stats.pickled == 0


def test_multiproc_refuses_a_cuda_store():
    g = pt_chol.cholesky_graph(2, 2, 1, 4)
    blocks, _ = pt_chol.make_spd_blocks(2, 4)
    with pytest.raises(ValueError, match="host payloads only"):
        g.run_host(blocks, pt_chol.cholesky_bodies_numpy(), device="cuda",
                   transport="multiproc")


# -------------------- cross-backend bit-identity, and against the reference

@pytest.mark.parametrize("pattern", PATTERNS)
def test_taskbench_sweep_bit_identical_across_backends(pattern):
    """The port on both backends and the JAX package's host runtime give
    the same blocks bit for bit (elementwise bodies: each product and sum
    is one IEEE rounding in torch and in numpy alike)."""
    blocks = pt_tb.taskbench_blocks(4, 3, seed=7)
    jg, _ = jx_tb.taskbench_graph(pattern, 4, 3, 2, seed=7)
    ref = jg.run_host(blocks, jx_tb.taskbench_bodies(), n_threads=2)
    for t in BACKENDS:
        g, _ = pt_tb.taskbench_graph(pattern, 4, 3, 2, seed=7)
        out = g.run_host(blocks, pt_tb.taskbench_bodies(), n_threads=2,
                         transport=t, device="cpu")
        assert out.keys() == ref.keys()
        for blk in ref:
            assert np.array_equal(out[blk].numpy(), np.asarray(ref[blk])), \
                (t, pattern, blk)


def test_cholesky_bit_identical_across_backends():
    nb, b = 4, 4
    blocks, a = pt_chol.make_spd_blocks(nb, b, seed=7)
    ref = jx_chol.cholesky_graph(nb, 2, 1, b).run_host(
        blocks, jx_chol.cholesky_bodies_numpy(), n_threads=2)
    for t in BACKENDS:
        out = pt_chol.cholesky_graph(nb, 2, 1, b).run_host(
            blocks, pt_chol.cholesky_bodies_numpy(), n_threads=2,
            transport=t, device="cpu")
        assert out.keys() == ref.keys()
        for blk in ref:
            assert np.array_equal(out[blk].numpy(), np.asarray(ref[blk])), \
                (t, blk)
    low = pt_chol.assemble_lower(out, nb, b).numpy()
    np.testing.assert_allclose(low @ low.T, a, atol=1e-3)
