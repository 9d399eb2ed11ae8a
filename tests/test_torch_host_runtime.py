"""The port's host TaskTorrent runtime on the CPU: threadpool, taskflow,
active messages, STF, the completion protocol and fault tolerance — the
port versions of ``tests/test_core_runtime.py``, ``test_completion.py`` and
``test_fault_tolerance.py``, at smaller sizes. AM payloads are exercised as
numpy arrays (pickled, as in the JAX package) and as tensors (copied on
their device, never pickled). The fault-tolerant Cholesky is held against
its own fault-free run bit for bit and against the JAX package's
``rederived_frac``.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro_torch.core import (READWRITE, FaultPlan, STFGraph, Task, Taskflow,
                              Threadpool, payload_stats, run_ranks, view)
from repro_torch.core.threadpool import current_thread_id

PAYLOADS = ["numpy", "tensor"]


def _payload(kind, values):
    arr = np.asarray(values)
    return arr if kind == "numpy" else torch.from_numpy(arr.copy())


def _delay_fn(seed: float, max_delay: float):
    rng = random.Random(seed)
    lock = threading.Lock()

    def fn(src, dst, kind):
        with lock:
            return rng.uniform(0.0, max_delay)

    return fn


# --------------------------------------------------------------- threadpool

@pytest.mark.parametrize("deferred", [False, True], ids=["started",
                                                          "deferred"])
def test_threadpool_runs_all_tasks(deferred):
    """Every inserted task runs; with ``start=False`` none runs before
    ``start()`` (the paper's micro-benchmark setup)."""
    n_threads = 2 if deferred else 4
    tp = Threadpool(n_threads, start=not deferred)
    done = []
    lock = threading.Lock()
    for i in range(200):
        tp.insert(Task(run=lambda i=i: (lock.acquire(), done.append(i),
                                        lock.release())), i % n_threads)
    if deferred:
        assert done == []
        tp.start()
    tp.join()
    assert sorted(done) == list(range(200))


def test_threadpool_priority_order():
    tp = Threadpool(1, start=False)
    order = []
    for i, prio in enumerate([1.0, 5.0, 3.0]):
        tp.insert(Task(run=lambda i=i: order.append(i), priority=prio), 0,
                  bound=True)
    tp.start()
    tp.join()
    assert order == [1, 2, 0]


def test_work_stealing_balances_load():
    tp = Threadpool(4)
    counter = {"done": 0}
    lock = threading.Lock()

    def body():
        time.sleep(0.002)
        with lock:
            counter["done"] += 1

    for _ in range(64):
        tp.insert(Task(run=body), 0, bound=False)
    tp.join()
    assert counter["done"] == 64
    assert tp.stats["steals"] > 0


def test_bound_tasks_never_stolen():
    tp = Threadpool(4)
    executed_on = []
    lock = threading.Lock()

    def body():
        with lock:
            executed_on.append(current_thread_id())
        time.sleep(0.001)

    for _ in range(32):
        tp.insert(Task(run=body), 1, bound=True)
    tp.join()
    assert set(executed_on) == {1}


# ----------------------------------------------------------------- taskflow

def test_taskflow_chain():
    tp = Threadpool(4)
    tf = Taskflow(tp, "chain")
    order = []
    tf.set_indegree(lambda k: 1)
    tf.set_mapping(lambda k: k % 4)

    def body(k):
        order.append(k)
        if k + 1 < 100:
            tf.fulfill_promise(k + 1)

    tf.set_task(body)
    tf.fulfill_promise(0)
    tp.join()
    assert order == list(range(100))


def test_taskflow_2d_wavefront():
    """Paper Fig 6 dependency pattern: (i,j) -> ((i+k)%nrows, j+1)."""
    nrows, ncols, ndeps = 8, 12, 3
    tp = Threadpool(4)
    tf = Taskflow(tp, "wave")
    done = set()
    lock = threading.Lock()
    tf.set_indegree(lambda ij: 1 if ij[1] == 0 else ndeps)
    tf.set_mapping(lambda ij: ij[0] % 4)

    def body(ij):
        i, j = ij
        with lock:
            if j > 0:
                for k in range(ndeps):
                    assert ((i - k) % nrows, j - 1) in done
            done.add(ij)
        if j + 1 < ncols:
            for k in range(ndeps):
                tf.fulfill_promise(((i + k) % nrows, j + 1))

    tf.set_task(body)
    for i in range(nrows):
        tf.fulfill_promise((i, 0))
    tp.join()
    assert len(done) == nrows * ncols


def test_taskflow_forgets_completed_tasks():
    tp = Threadpool(2)
    tf = Taskflow(tp, "mem")
    tf.set_indegree(lambda k: 1)
    tf.set_mapping(lambda k: 0)
    tf.set_task(lambda k: None)
    for k in range(64):
        tf.fulfill_promise(k)
    tp.join()
    assert tf.pending() == 0
    assert tf.snapshot() == {"name": "mem", "live": 0, "per_thread": [0, 0]}


def test_taskflow_indegree_must_be_positive():
    tp = Threadpool(1)
    tf = Taskflow(tp, "bad")
    tf.set_indegree(lambda k: 0)
    tf.set_mapping(lambda k: 0)
    tf.set_task(lambda k: None)
    tf.fulfill_promise(7)
    with pytest.raises(ValueError, match="indegree"):
        tp.join()


# ------------------------------------------------------------ distributed AM

@pytest.mark.parametrize("kind", PAYLOADS)
def test_active_message_roundtrip(kind):
    """Rank 0 sends AMs to rank 1; payloads arrive intact, numpy pickled and
    tensors copied beside the pickle (none pickled under inproc)."""

    def main(ctx):
        received = []
        am = ctx.comm.make_active_msg(lambda k, x: received.append((k, x)))
        if ctx.rank == 0:
            for k in range(10):
                am.send(1, k, _payload(kind, [k, k * k]))
        ctx.tp.join()
        return received

    payload_stats.reset()
    res = run_ranks(2, main, n_threads=2)
    assert res[0] == []
    got = sorted((k, list(np.asarray(x))) for k, x in res[1])
    assert got == [(k, [k, k * k]) for k in range(10)]
    assert all(isinstance(x, torch.Tensor) == (kind == "tensor")
               for _, x in res[1])
    assert payload_stats.pickled == 0
    assert payload_stats.copied == (10 if kind == "tensor" else 0)
    assert payload_stats.pairs == {
        (0, 1): [10, 160 if kind == "tensor" else 0]}


@pytest.mark.parametrize("wrap", ["view", "tensor", "nested"])
def test_payload_reusable_after_send(wrap):
    """send() copies immediately: mutating the argument after send is
    safe, for a view, a bare tensor, and a tensor inside a tuple."""

    def main(ctx):
        received = []
        am = ctx.comm.make_active_msg(lambda arr: received.append(arr))
        if ctx.rank == 0:
            buf = torch.arange(8)
            arg = {"view": view(buf), "tensor": buf, "nested": (1, buf)}[wrap]
            am.send(1, arg)
            buf[:] = -1
        ctx.tp.join()
        return received

    res = run_ranks(2, main)
    got = res[1][0][1] if wrap == "nested" else res[1][0]
    assert torch.equal(got, torch.arange(8))


@pytest.mark.parametrize("kind", PAYLOADS)
def test_large_am_three_callbacks(kind):
    """Large AM: alloc on receiver (numpy or tensor buffer), process on
    receiver, complete on sender."""

    def main(ctx):
        state = {"buf": None, "processed": False, "sender_done": False}

        def alloc(n):
            state["buf"] = (np.zeros(n) if kind == "numpy"
                            else torch.zeros(n, dtype=torch.float64))
            return state["buf"]

        def process(n):
            state["processed"] = True

        def complete():
            state["sender_done"] = True

        lam = ctx.comm.make_large_active_msg(process, alloc, complete)
        if ctx.rank == 0:
            lam.send(1, 32, view(np.linspace(0.0, 1.0, 32)))
        ctx.tp.join()
        return state

    res = run_ranks(2, main)
    assert res[0]["sender_done"] is True
    assert res[1]["processed"] is True
    np.testing.assert_allclose(np.asarray(res[1]["buf"]),
                               np.linspace(0.0, 1.0, 32))


def test_am_triggers_remote_taskflow():
    def main(ctx):
        data = {}
        tf = ctx.taskflow("remote")
        out = []
        tf.set_indegree(lambda k: 1)
        tf.set_mapping(lambda k: k % 2)
        tf.set_task(lambda k: out.append((k, int(data[k]))))
        am = ctx.comm.make_active_msg(
            lambda d, payload: (data.__setitem__(d, payload),
                                tf.fulfill_promise(d)))
        if ctx.rank == 0:
            for d in range(6):
                am.send(1, d, torch.tensor(d * 10))
        ctx.tp.join()
        return sorted(out)

    assert run_ranks(2, main)[1] == [(d, d * 10) for d in range(6)]


def test_am_registration_order_mismatch_detected():
    def main(ctx):
        if ctx.rank == 0:
            ctx.comm.make_active_msg(lambda: None)
        else:
            def other(): pass
            ctx.comm.make_active_msg(other)
        time.sleep(0.05)
        ctx.comm.make_active_msg(lambda: None)
        ctx.tp.join()

    with pytest.raises(RuntimeError):
        run_ranks(2, main)


# ---------------------------------------------------------------- STF model

def _logger():
    log, lock = [], threading.Lock()

    def mk(name):
        def fn():
            with lock:
                log.append(name)
        return fn
    return log, mk


def test_stf_infers_raw_war_waw():
    tp = Threadpool(2)
    g = STFGraph(tp)
    log, mk = _logger()
    g.submit(mk("w1"), [("x", "W")])
    g.submit(mk("r1"), [("x", "R")])
    g.submit(mk("r2"), [("x", "R")])
    g.submit(mk("w2"), [("x", "W")])
    g.submit(mk("rw"), [("x", READWRITE)])
    g.execute()
    tp.join()
    assert log.index("w1") < log.index("r1") < log.index("w2")
    assert log.index("w1") < log.index("r2") < log.index("w2")
    assert log.index("w2") < log.index("rw")


def test_stf_execute_is_one_shot_and_reset_reruns():
    tp = Threadpool(2)
    g = STFGraph(tp)
    log, mk = _logger()
    g.submit(mk("w"), [("x", "W")])
    g.submit(mk("r"), [("x", "R")])
    g.submit(mk("w2"), [("x", "W")])
    for _ in range(2):
        g.execute()
        assert log == ["w", "r", "w2"], log
        log.clear()
        with pytest.raises(RuntimeError, match="already ran"):
            g.execute()
        assert log == []
        g.reset()
    tp.join()


# ------------------------------------------------- completion (§II-B3)

@settings(deadline=None, max_examples=6,
          suppress_health_check=[HealthCheck.too_slow])
@given(n_ranks=st.integers(2, 3), n_msgs=st.integers(1, 12),
       seed=st.integers(0, 2**31),
       max_delay=st.sampled_from([0.0, 0.002, 0.02]))
def test_no_early_termination_scatter(n_ranks, n_msgs, seed, max_delay):
    def main(ctx):
        received = []
        am = ctx.comm.make_active_msg(lambda i, t: received.append(int(t)))
        if ctx.rank == 0:
            for i in range(n_msgs):
                am.send(1 + (i % (ctx.n_ranks - 1)), i, torch.tensor(i))
        ctx.tp.join()
        return received

    res = run_ranks(n_ranks, main, delay_fn=_delay_fn(seed, max_delay),
                    timeout=60.0)
    assert sorted(x for r in res for x in r) == list(range(n_msgs))


@settings(deadline=None, max_examples=5,
          suppress_health_check=[HealthCheck.too_slow])
@given(n_ranks=st.integers(2, 3), hops=st.integers(1, 15),
       seed=st.integers(0, 2**31))
def test_ping_pong_chain(n_ranks, hops, seed):
    def main(ctx):
        count = [0]
        holder = {}

        def on_hop(i):
            count[0] += 1
            if i + 1 < hops:
                holder["am"].send((ctx.rank + 1) % ctx.n_ranks, i + 1)

        holder["am"] = ctx.comm.make_active_msg(on_hop)
        if ctx.rank == 0:
            holder["am"].send(1 % ctx.n_ranks, 0)
        ctx.tp.join()
        return count[0]

    res = run_ranks(n_ranks, main, delay_fn=_delay_fn(seed, 0.005),
                    timeout=60.0)
    assert sum(res) == hops


@settings(deadline=None, max_examples=4,
          suppress_health_check=[HealthCheck.too_slow])
@given(n_ranks=st.integers(2, 3), width=st.integers(1, 4),
       depth=st.integers(1, 4), seed=st.integers(0, 2**31))
def test_task_cascade_across_ranks(n_ranks, width, depth, seed):
    def main(ctx):
        done = []
        tf = ctx.taskflow("cascade")
        holder = {}
        tf.set_indegree(lambda k: 1)
        tf.set_mapping(lambda k: k[1] % ctx.tp.n_threads)

        def body(k):
            level, i = k
            done.append(k)
            if level + 1 < depth:
                holder["am"].send((ctx.rank + 1) % ctx.n_ranks,
                                  (level + 1, i))

        tf.set_task(body)
        holder["am"] = ctx.comm.make_active_msg(
            lambda k: tf.fulfill_promise(tuple(k)))
        if ctx.rank == 0:
            for i in range(width):
                tf.fulfill_promise((0, i))
        ctx.tp.join()
        return len(done)

    res = run_ranks(n_ranks, main, delay_fn=_delay_fn(seed, 0.003),
                    timeout=60.0)
    assert sum(res) == width * depth


def test_empty_program_terminates():
    def main(ctx):
        ctx.tp.join()
        return True

    assert run_ranks(3, main, timeout=30.0) == [True, True, True]


def test_counters_exclude_protocol_traffic():
    def main(ctx):
        am = ctx.comm.make_active_msg(lambda t: None)
        if ctx.rank == 0:
            am.send(1, torch.zeros(2))
        ctx.tp.join()
        return (ctx.comm.queued_count, ctx.comm.processed_count)

    assert run_ranks(2, main, timeout=30.0) == [(1, 0), (0, 1)]


# ------------------------------------------------------- fault tolerance

@settings(deadline=None, max_examples=20,
          suppress_health_check=[HealthCheck.too_slow])
@given(n_ranks=st.integers(2, 3), n_msgs=st.integers(1, 8),
       seed=st.integers(0, 2**31),
       drop=st.sampled_from([0.0, 0.05, 0.15, 0.3]),
       dup=st.sampled_from([0.0, 0.05, 0.15, 0.3]),
       max_delay=st.sampled_from([0.0, 0.001]))
def test_lossy_schedule_never_early_shutdown(n_ranks, n_msgs, seed, drop,
                                             dup, max_delay):
    """Seeded loss + duplication + reorder: every tensor payload processed
    exactly once at shutdown, and the run terminates."""
    plan = FaultPlan(seed=seed, drop=drop, duplicate=dup)

    def main(ctx):
        received = []
        am = ctx.comm.make_active_msg(lambda t: received.append(int(t)))
        if ctx.rank == 0:
            for i in range(n_msgs):
                am.send(1 + (i % (ctx.n_ranks - 1)), torch.tensor(i))
        ctx.tp.join()
        return received

    res, report = run_ranks(n_ranks, main, faults=plan, timeout=60.0,
                            delay_fn=_delay_fn(seed, max_delay))
    got = sorted(x for r in res for x in r)
    assert got == list(range(n_msgs)), report.to_dict()


def test_counters_count_each_user_am_once_under_faults():
    plan = FaultPlan(seed=7, drop=0.3, duplicate=0.3)

    def main(ctx):
        am = ctx.comm.make_active_msg(lambda i: None)
        if ctx.rank == 0:
            for i in range(30):
                am.send(1, i)
        ctx.tp.join()
        return ctx.comm.effective_counts()

    res, report = run_ranks(2, main, faults=plan, timeout=60.0)
    assert res == [(30, 0), (0, 30)]
    assert report.retries > 0 and report.injected_drops > 0


def test_duplicates_suppressed_by_seq_dedup():
    plan = FaultPlan(seed=3, drop=0.0, duplicate=0.5)

    def main(ctx):
        received = []
        am = ctx.comm.make_active_msg(lambda i: received.append(i))
        if ctx.rank == 0:
            for i in range(30):
                am.send(1, i)
        ctx.tp.join()
        return received

    res, report = run_ranks(2, main, faults=plan, timeout=60.0)
    assert sorted(res[1]) == list(range(30))
    assert report.injected_dups > 0 and report.dup_suppressed > 0


def test_rank_death_declared_and_survivors_finish():
    plan = FaultPlan(seed=11, drop=0.05, duplicate=0.05, kill={2: 3})

    def main(ctx):
        received = []
        am = ctx.comm.make_active_msg(lambda i: received.append(i))
        if ctx.rank != 0:
            for i in range(10):
                am.send(0, ctx.rank * 100 + i)
        ctx.tp.join()
        return received

    res, report = run_ranks(3, main, faults=plan, timeout=60.0)
    assert res[2] is None
    assert report.deaths == [2]
    got = sorted(res[0])
    assert [x for x in got if x < 200] == [100 + i for i in range(10)]
    from_dead = [x for x in got if x >= 200]
    assert set(from_dead) <= {200, 201}
    assert len(from_dead) == len(set(from_dead))


def test_fault_plan_validates():
    with pytest.raises(ValueError):
        FaultPlan(drop=1.5)
    with pytest.raises(ValueError):
        FaultPlan(kill={0: 2})


def test_timeout_reports_stuck_ranks_with_protocol_state():
    def main(ctx):
        if ctx.rank == 1:
            while not ctx.comm.world.poison.is_set():
                time.sleep(0.002)
        ctx.tp.join()

    with pytest.raises(TimeoutError) as ei:
        run_ranks(2, main, timeout=1.0)
    msg = str(ei.value)
    assert "deadlock" in msg and "rank 1" in msg and "queued" in msg


def test_rank_exception_propagates_with_traceback():
    def main(ctx):
        if ctx.rank == 1:
            raise ValueError("boom at rank 1")
        ctx.tp.join()

    with pytest.raises(RuntimeError) as ei:
        run_ranks(2, main, timeout=30.0)
    msg = str(ei.value)
    assert "rank 1 failed" in msg and "ValueError: boom at rank 1" in msg
    assert "in main" in msg
    assert isinstance(ei.value.__cause__, ValueError)


def test_cholesky_bit_identical_under_loss_dup_and_kill():
    """10% loss + 10% duplication + one mid-run kill on the 8-rank Cholesky
    host run with torch CPU bodies: bit for bit the fault-free run, the
    re-derivation confined to the moved shard, and the same
    ``rederived_frac`` as the JAX package's run of the same plan."""
    from repro.linalg import cholesky as jx_chol
    from repro_torch.linalg.cholesky import (cholesky_bodies, cholesky_graph,
                                             make_spd_blocks)

    nb, b, pr, pc = 6, 4, 4, 2
    g = cholesky_graph(nb, pr, pc, b)
    blocks, _ = make_spd_blocks(nb, b, seed=0)
    ref = g.run_host(blocks, cholesky_bodies(), device="cpu")
    plan = FaultPlan(seed=5, drop=0.10, duplicate=0.10, kill={3: 2})
    out, report = g.run_host(blocks, cholesky_bodies(), faults=plan,
                             timeout=120.0, device="cpu")
    assert set(out) == set(ref)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    assert report.deaths == [3] and report.rederived_shards == [3]
    assert report.reexecuted_tasks > 0
    assert report.recovery_seconds is not None

    _, jx_report = jx_chol.cholesky_graph(nb, pr, pc, b).run_host(
        blocks, jx_chol.cholesky_bodies_numpy(), faults=plan, timeout=120.0)
    assert report.total_edges == jx_report.total_edges
    assert report.rederived_frac == jx_report.rederived_frac < 0.5
