"""The port's block executor on real ranks, on the CPU: one spawned process
per shard, joined into a gloo group (``repro_torch.dist.ranks``).

- over ``tests/test_torch_linalg.py``'s ``BIT_CASES`` x ``VARIANTS`` (every
  lowering: the dense scan, the segmented scan with and without the union
  cover, unrolled, each with and without ``overlap``, and the auto
  policy), each rank's row equals the one-device executor's row of its
  shard bit for bit, halo copies included;
- the bytes each rank sends each peer equal what the lowering's tables
  ship (``wire_blocks``), and their sum equals ``comm_stats`` for that
  lowering (the dense scan, which ``comm_stats`` does not account, ships
  ``W · n² · M_max`` blocks, ``plan_lowering``'s count);
- ``REF_CASES`` under the auto policy are within 2e-5 of the JAX package's
  executor (its outputs from ``tests/test_torch_linalg.py``'s script mode:
  8 forced host devices, jnp bodies);
- a group of another size than the program's shards raises, a rank that
  raises or hangs fails ``spawn_ranks`` within its deadline, and a rank
  child imports nothing of JAX or of ``repro``.

Each world is spawned once for the module: a 4-rank world for the cases of
4 shards, an 8-rank world for ``cholesky_8x4x2`` and ``gemm3d``.
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.test_torch_linalg import (BIT_CASES, REF_CASES, REPO, VARIANTS,
                                     _case, _port_case, _real_slots)

from repro_torch.dist import ranks
from repro_torch.linalg import cholesky, gemm
from repro_torch import taskbench


def _job(name, runs):
    """The rank-side entry of one named case of ``_case``, with ``runs``."""
    kind, *rest = name.split("_")
    if kind == "gemm2d":
        nb, b = (4, 8) if "small" not in rest else (4, 4)
        return (gemm.gemm_rank, (nb, b, runs), {"staged": "staged" in rest})
    if kind == "gemm3d":
        return (gemm.gemm_rank, (4, 8, runs), {"q": 2})
    if kind == "cholesky":
        nb, pr, pc, b = {"": (5, 2, 2, 8), "6": (6, 2, 2, 4),
                         "8x4x2": (8, 4, 2, 4)}["".join(rest)]
        return (cholesky.cholesky_rank, (nb, pr, pc, b, runs), {})
    depth = int(rest[1]) if len(rest) > 1 else 6
    return (taskbench.taskbench_rank, (rest[0], 8, depth, 4, 4, runs),
            {"fan": 2})


VARIANT_RUNS = [dict(VARIANTS[v], name=v) for v in sorted(VARIANTS)]
REF_RUN = [{"name": "auto", "auto": True}]


def _world(n):
    """Spawn one world of ``n`` ranks that runs every case of ``n`` shards
    (every variant of the bit cases; the auto policy of the reference
    cases not among them), then the import probe. Returns ``{(case,
    variant): [run of rank 0, ...]}`` and the probe's per-rank modules."""
    bit = [c for c in BIT_CASES if _port_case(c)[0].spec.n_shards == n]
    ref = [c for c in REF_CASES if c not in BIT_CASES
           and _case(c, jax_side=False)[0].spec.n_shards == n]
    jobs = ([_job(c, VARIANT_RUNS) for c in bit]
            + [_job(c, REF_RUN) for c in ref]
            + [(ranks.rank_probe, (), {})])
    per_rank = ranks.spawn_ranks(ranks.run_jobs, n, jobs, device="cpu",
                                 timeout=600)
    out = {}
    for j, case in enumerate(bit + ref):
        for run_i, run in enumerate(per_rank[0][j]):
            out[(case, run["name"])] = [per_rank[r][j][run_i]
                                        for r in range(n)]
    return out, [per_rank[r][-1] for r in range(n)]


@pytest.fixture(scope="module")
def worlds():
    runs, modules = {}, []
    for n in (4, 8):
        got, mods = _world(n)
        runs.update(got)
        modules += mods
    return runs, modules


def _rows(runs):
    return {run["rank"]: dict(zip(run["slots"], run["row"])) for run in runs}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", BIT_CASES)
def test_ranks_equal_one_device_bit_for_bit(worlds, name, variant):
    prog, _, _, ref = _port_case(name)
    rows = _rows(worlds[0][(name, variant)])
    for s, slot in _real_slots(prog):
        assert torch.equal(rows[s][slot], ref[s, slot]), (name, variant,
                                                         s, slot)


def _wire_total(prog, kw):
    """Bytes the lowering that ``kw`` picks puts on the wire in one call."""
    kw = dict(kw)
    if kw.pop("auto", False):
        plan = prog.plan_lowering(**kw)
        mode, cover = plan["mode"], plan["cover"]
        scan, comm = mode != "unrolled", kw.get("comm", "auto")
        if mode == "dense_scan":
            comm, cover = "dense", "exact"
        overlap = kw.get("overlap", True) and mode != "dense_scan"
    else:
        scan, cover = kw.get("scan", True), kw.get("cover", "exact")
        comm = kw.get("comm", "dense" if scan else "auto")
        overlap = kw.get("overlap", False)
    n, bb = prog.spec.n_shards, prog.comm_stats()["block_bytes"]
    if scan and comm == "dense" and not overlap:
        m_max = max(e[0].shape[-1] for e in prog.exchange)
        return len(prog.exchange) * n * n * m_max * bb
    return prog.comm_stats(comm=comm, segmented=scan,
                           cover=cover)["total_wire_bytes"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", BIT_CASES)
def test_bytes_per_rank_pair_equal_the_tables_and_comm_stats(worlds, name,
                                                             variant):
    prog = _port_case(name)[0]
    bb = prog.comm_stats()["block_bytes"]
    runs = worlds[0][(name, variant)]
    for run in runs:
        assert run["sent_bytes"] == [m * bb for m in run["wire_blocks"]], (
            run["rank"])
        assert run["staged_bytes"] == 0          # CPU stores: sent as they are
    total = sum(sum(run["sent_bytes"]) for run in runs)
    assert total == _wire_total(prog, VARIANTS[variant])


@pytest.fixture(scope="module")
def reference_outputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_reference") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    proc = subprocess.run([sys.executable, os.path.join(
        REPO, "tests", "test_torch_linalg.py"), str(path)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name", REF_CASES)
def test_ranks_match_jax_executor(worlds, reference_outputs, name):
    prog = _case(name, jax_side=False)[0]
    rows = _rows(worlds[0][(name, "auto")])
    want = reference_outputs[name]
    for s, slot in _real_slots(prog):
        np.testing.assert_allclose(rows[s][slot].numpy(), want[s, slot],
                                   rtol=2e-5, atol=2e-5,
                                   err_msg=f"{name} shard {s} slot {slot}")


def test_rank_children_import_no_jax_or_repro(worlds):
    modules = worlds[1]
    assert len(modules) == 12 and all("torch" in m for m in modules)
    for mods in modules:
        assert not {"jax", "jaxlib", "repro"} & set(mods), mods


def test_group_of_another_size_raises_value_error(monkeypatch):
    """A one-rank group cannot run a program of four shards, as the JAX
    package's executor refuses a mesh axis of another size; a program of
    one shard runs on it; a rank on ``cuda`` without a GPU raises."""
    prog, _, bodies = _case("gemm2d", jax_side=False)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            tmp, "rendezvous"), world_size=1, rank=0)
        try:
            for make in (prog.executor, prog.auto_executor):
                with pytest.raises(ValueError, match="1 ranks != 4 shards"):
                    make(bodies, device="cpu", group=dist.group.WORLD)
            # one shard on one rank: its row is the one-device store (but
            # the trash slot), and another shape of store raises
            one = gemm.gemm_2d_program(4, 1, 1, 4)
            blocks, bodies = gemm.make_blocks(None, 4, 4), gemm.gemm_bodies()
            ex = one.executor(bodies, device="cpu", group=dist.group.WORLD)
            row = one.pack_shard(blocks, 0, "cpu")
            want = one.executor(bodies, device="cpu")(
                one.pack(blocks, device="cpu"))
            assert torch.equal(ex(row)[:, :-1], want[:, :-1])
            with pytest.raises(ValueError, match="store has shape"):
                ex(row[:, :-1])
            monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="is_available"):
                prog.executor(bodies, device="cuda", group=dist.group.WORLD)
        finally:
            dist.destroy_process_group()


def test_cuda_without_a_gpu_raises_before_spawning(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ranks.spawn_ranks(ranks.rank_probe, 2, device="cuda", timeout=30)


def test_a_failing_rank_fails_the_world_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose") as err:
        ranks.spawn_ranks(ranks.rank_probe, 2, 1, device="cpu", timeout=120)
    first = str(err.value).split("\n", 1)[1].split("\nrank ")[0]
    assert first.startswith("rank 1:\nTraceback")    # the first to fail
    assert "fails on purpose" in first
    assert time.monotonic() - t0 < 120


def tensors_rank(rank, world, tensors, *, device):
    """The sum of the CPU tensors this rank was given, and whether they
    share the parent's memory."""
    return float(sum(t.sum() for t in tensors)), all(
        t.is_shared() for t in tensors)


def test_a_world_takes_more_cpu_tensors_than_a_process_takes_fds():
    """Each CPU tensor in the call's arguments lends its shared memory by
    a file descriptor: 300 of them reach every rank, which a fork server
    would refuse with the process itself (at most ~250 descriptors)."""
    tensors = [torch.full((4,), float(i)) for i in range(300)]
    got = ranks.spawn_ranks(tensors_rank, 2, tensors, device="cpu",
                            timeout=120)
    assert got == [(4.0 * sum(range(300)), True)] * 2


@pytest.mark.parametrize("how", ["exit", "kill"])
def test_a_rank_killed_by_a_signal_is_told_from_one_that_exits(how):
    """``RankDied`` names a rank that a signal killed, and only such a
    rank: one that calls ``sys.exit`` fails the world with its traceback,
    as one that raises does."""
    with pytest.raises(RuntimeError) as err:
        ranks.spawn_ranks(ranks.rank_probe, 2, 1, None, how, device="cpu",
                          timeout=120)
    if how == "kill":
        assert isinstance(err.value, ranks.RankDied)
        assert err.value.ranks == [1]
        assert "rank 1: killed by signal 9" in str(err.value)
    else:
        assert not isinstance(err.value, ranks.RankDied)
        assert "SystemExit: rank 1 exits on purpose" in str(err.value)


def test_a_hung_rank_fails_the_world_within_its_deadline():
    """Rank 1 never returns and rank 0 waits for it in a barrier: the
    barrier's timeout or the call's deadline ends the world."""
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        ranks.spawn_ranks(ranks.rank_probe, 2, None, 1, device="cpu",
                          timeout=15)
    assert time.monotonic() - t0 < 15 + 40      # + the children's teardown


def test_distributed_cholesky_example_on_ranks():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "torch_distributed_cholesky.py"),
         "--nb", "6", "--block", "8", "--device", "cpu", "--ranks", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("[ranks]")][0]
    assert float(line.split("max|err|=")[1].split()[0]) < 1e-5
    assert proc.stdout.count("  rank ") == 4
