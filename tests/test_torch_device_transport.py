"""The device transport of rank processes (``dist.ranks.Mailbox``,
``DeviceTransport``, ``DeviceTensorTransport``), on the CPU: the same
protocol as on the card, over shared files in the world's directory.

- small block-executor worlds (Cholesky, GEMM 2D staged, Task-Bench
  stencil and fft on 4 ranks, the attention chain on 2) under several
  lowerings: each rank's row bit for bit the one-device executor's and
  the gloo transport's, bytes per rank pair the lowering's tables and
  their sum ``comm_stats``, nothing staged;
- the model path's operations: sends taken by tag out of order, a bf16
  all-gather and broadcast, a tensor larger than the mailbox (in pieces),
  all bit for bit; an all-reduce on the world and on sub-groups equal on
  every member to the f32 sum in the group's rank order as a balanced
  tree, ``(t0 + t1) + (t2 + t3)``, and refusing any other dtype;
- a tensor-parallel (1, 2) serve cell and train step of the reduced yi-6b
  bit for bit the gloo run (on two members a + b is exact in either
  order), with the same bytes by kind;
- a rank that raises, is killed or hangs while its peer waits in the
  mailbox fails the world within its deadline.

The mailboxes are cut to a few KiB so that every exchange goes in pieces
and ranks wait for room. The rank functions live here (a spawned child
imports this module); it imports nothing of JAX.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import taskbench
from repro_torch.attention_chain import chain_blocks, chain_bodies, chain_graph
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.schedule import build_block_program
from repro_torch.dist import ranks
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.ctx import launch_mesh
from repro_torch.launch.mesh import Mesh
from repro_torch.linalg import cholesky, gemm
from repro_torch.models import transformer as tfm
from repro_torch.serve.decode import make_serve_step
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import leaf_paths

# name -> (rank function, its arguments before ``runs``, keyword arguments)
CASES = {
    "cholesky": (cholesky.cholesky_rank, (6, 2, 2, 4), {}),
    "gemm2d_staged": (gemm.gemm_rank, (4, 8), {"staged": True}),
    "taskbench_stencil": (taskbench.taskbench_rank, ("stencil", 8, 9, 4, 4),
                          {"fan": 2}),
    "taskbench_fft": (taskbench.taskbench_rank, ("fft", 8, 9, 4, 4),
                      {"fan": 2}),
    "chain": (None, (3, 8, 4), {}),
}
VARIANTS = {
    "scan_dense": dict(scan=True),
    "scan_auto_overlap": dict(scan=True, comm="auto", overlap=True),
    "unrolled_sparse_overlap": dict(scan=False, comm="sparse", overlap=True),
    "auto": dict(auto=True),
}
RUNS = [dict(kw, name=name) for name, kw in VARIANTS.items()]
BOX = 8192              # bytes a mailbox holds: pieces of 1 KiB
TP_BOX = 64 << 10       # the tensor-parallel cells': pieces of 8 KiB
B, S, STEPS = 4, 16, 4  # the serve cell's batch, prompt and greedy steps


def _program(name):
    """(program, blocks, bodies) of a case, as its rank function makes
    them."""
    if name == "cholesky":
        blocks, _ = cholesky.make_spd_blocks(6, 4)
        return (cholesky.cholesky_program(6, 2, 2, 4), blocks,
                cholesky.cholesky_bodies())
    if name == "gemm2d_staged":
        return (gemm.gemm_2d_program(4, 2, 2, 8, staged=True),
                gemm.make_blocks(None, 4, 8), gemm.gemm_bodies())
    if name == "chain":
        return (chain_graph(3, 8, 4, 2).to_program(),
                chain_blocks(3, 8, 4, 7, "cpu"), chain_bodies(True))
    pattern = name.split("_")[1]
    spec, _ = taskbench.taskbench_spec(pattern, 8, 9, 4, 4, fan=2)
    return (build_block_program(spec), taskbench.taskbench_blocks(8, 9, 4),
            taskbench.taskbench_bodies())


def _jobs(names):
    from repro_torch.attention_chain import chain_rank

    return [((chain_rank if fn is None else fn), (*args, RUNS), kw)
            for fn, args, kw in (CASES[n] for n in names)]


# ------------------------------------------------------ rank functions

def _draw(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(dtype)


def ops_rank(rank, world, *, device):
    """The model path's operations on a world of 4: sends by tag out of
    order, bf16 all-gathers and a broadcast, a tensor larger than the
    mailbox, all-reduces on the world and on two sub-groups, one of
    another dtype; what arrived and the counters."""
    net = ranks.tensor_transport(device)
    pairs = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    out = {"transport": type(net).__name__}
    if rank == 0:
        for tag in (3, 1, 2):
            net.send(_draw((5, 7), tag, torch.bfloat16), 1, tag=tag)
        net.send(_draw((3, BOX), 9), 1, tag=4)      # 12 KiB: in pieces
    if rank == 1:
        out["tags"] = {t: net.recv((5, 7), torch.bfloat16, 0, tag=t)
                       for t in (2, 3, 1)}
        out["big"] = net.recv((3, BOX), torch.float32, 0, tag=4)
    net.wait_sends()
    out["gather"] = net.all_gather(_draw((6, 3), 20 + rank, torch.bfloat16),
                                   dist.group.WORLD)
    out["pair_gather"] = net.all_gather(_draw((2, 700), 30 + rank),
                                        pairs[rank % 2])
    out["bcast"] = net.broadcast(_draw((9, 5), 40 + rank, torch.bfloat16), 2,
                                 dist.group.WORLD)
    out["reduce"] = net.all_reduce(_draw((3, 1000), 50 + rank),
                                   dist.group.WORLD)
    out["pair_reduce"] = net.all_reduce(_draw((1001,), 60 + rank),
                                        pairs[rank % 2])
    out["scalar"] = net.all_reduce(torch.tensor(float(rank)),
                                   dist.group.WORLD)
    try:
        net.all_reduce(torch.ones(4, dtype=torch.bfloat16), dist.group.WORLD)
    except TypeError as exc:
        out["refused"] = str(exc)
    out["bytes"] = {k: list(v) for k, v in net.bytes.items()}
    out["msgs"] = {k: list(v) for k, v in net.msgs.items()}
    out["staged_bytes"] = net.staged_bytes
    out["ms"], out["busy_ms"] = net.ms, net.busy_ms()
    return out


def _tp_cfg():
    return reduced(get_config("yi-6b"), compute_dtype="float32")


def tp2_rank(rank, world, *, device):
    """A (1, 2) tensor-parallel cell of the reduced yi-6b from seeded
    shards: the prefill logits and ``STEPS`` greedy serve steps, then two
    train steps; the results and the bytes by kind."""
    cfg = _tp_cfg()
    mesh = Mesh((1, 2), ("data", "model"), device, group=dist.group.WORLD)
    params = tp.init_shard_params(cfg, mesh, seed=0, device=device)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    net = mesh.transport
    out = {"transport": type(net).__name__}
    with torch.inference_mode(), launch_mesh(mesh, global_batch=B):
        tokens = torch.from_numpy(toks).to(device)
        out["prefill"] = tfm.prefill(cfg, params, tokens=tokens)
        cache = tp.init_shard_cache(cfg, mesh, B, S + STEPS, torch.float32,
                                    device=device)
        step = make_serve_step(cfg)
        tok, got = tokens[:, 0], []
        for _ in range(STEPS):
            tok, lg, cache = step(params, tok, cache)
            got.append((tok, lg))
        out["steps"] = got
    out["serve_bytes"] = {k: list(v) for k, v in net.bytes.items()}
    net.reset()
    data = SyntheticLM(cfg.vocab_size, S, B, seed=5)
    train = make_train_step(cfg, lr=1e-3, mesh=mesh)
    params = tp.init_shard_params(cfg, mesh, seed=1, device=device)
    opt = adamw_init(params)
    out["metrics"] = []
    for s in range(2):
        batch = {k: torch.from_numpy(v.copy()).to(device)
                 for k, v in data.batch_at(s).items()}
        params, opt, metrics = train(params, opt, batch)
        out["metrics"].append(metrics)
    out["params"] = params
    out["train_bytes"] = {k: list(v) for k, v in net.bytes.items()}
    return out


def fault_rank(rank, world, how, *, device):
    """One all-reduce that completes, then rank 1 raises, dies by SIGKILL
    or hangs while rank 0 waits for it in a second one."""
    net = ranks.tensor_transport(device)
    net.all_reduce(torch.ones(8), dist.group.WORLD)
    if rank == 1:
        ranks.rank_probe(1, world, *((1, None, how) if how != "hang"
                                     else (None, 1)), device=device)
    net.all_reduce(torch.ones(8), dist.group.WORLD)


# ------------------------------------------------------------- worlds

@pytest.fixture(scope="module")
def executor_worlds():
    """Per transport: ``{(case, variant): [run of each rank]}``."""
    four = [n for n in CASES if n != "chain"]
    out = {}
    for transport in ("device", "gloo"):
        got = {}
        for names, n in ((four, 4), (["chain"], 2)):
            per_rank = ranks.spawn_ranks(
                ranks.run_jobs, n, _jobs(names), device="cpu", timeout=300,
                transport=transport, mailbox_bytes=BOX)
            for j, name in enumerate(names):
                for i, run in enumerate(RUNS):
                    got[(name, run["name"])] = [per_rank[r][j][i]
                                                for r in range(n)]
        out[transport] = got
    return out


@pytest.fixture(scope="module")
def one_device():
    out = {}
    for name in CASES:
        prog, blocks, bodies = _program(name)
        out[name] = prog.executor(bodies, device="cpu", scan=False,
                                  comm="dense")(prog.pack(blocks,
                                                          device="cpu"))
    return out


@pytest.fixture(scope="module")
def ops():
    return ranks.spawn_ranks(ranks.run_jobs, 4, [
        (ops_rank, (), {}), (ranks.rank_probe, (), {})], device="cpu",
        timeout=300, transport="device", mailbox_bytes=BOX)


@pytest.fixture(scope="module")
def tp2_worlds():
    return {transport: ranks.spawn_ranks(
        tp2_rank, 2, device="cpu", timeout=300, transport=transport,
        mailbox_bytes=TP_BOX) for transport in ("device", "gloo")}


def _real_slots(prog):
    return ([(s, slot) for (s, slot) in prog.slot_of.values()]
            + [(s, slot) for (s, _), slot in prog.halo_slot.items()])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", list(CASES))
def test_executor_equals_one_device_and_gloo_bit_for_bit(
        executor_worlds, one_device, name, variant):
    prog = _program(name)[0]
    rows = {t: {run["rank"]: dict(zip(run["slots"], run["row"]))
                for run in executor_worlds[t][(name, variant)]}
            for t in ("device", "gloo")}
    for s, slot in _real_slots(prog):
        got = rows["device"][s][slot]
        assert torch.equal(got, one_device[name][s, slot]), (s, slot)
        assert torch.equal(got, rows["gloo"][s][slot]), (s, slot)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", list(CASES))
def test_executor_bytes_per_pair_equal_the_tables_and_comm_stats(
        executor_worlds, name, variant):
    prog = _program(name)[0]
    bb = prog.comm_stats()["block_bytes"]
    runs = executor_worlds["device"][(name, variant)]
    gloo = executor_worlds["gloo"][(name, variant)]
    for run, twin in zip(runs, gloo):
        assert run["transport"] == "device" and twin["transport"] == "gloo"
        assert run["mailbox_bytes"] == BOX and twin["mailbox_bytes"] == 0
        assert run["staged_bytes"] == 0 and run["stage_ms"] == 0.0
        assert run["sent_bytes"] == [m * bb for m in run["wire_blocks"]]
        assert (run["sent_bytes"], run["sent_msgs"]) == (
            twin["sent_bytes"], twin["sent_msgs"])
    total = sum(sum(run["sent_bytes"]) for run in runs)
    assert total == _wire_total(prog, VARIANTS[variant])


def _wire_total(prog, kw):
    """Bytes the lowering that ``kw`` picks puts on the wire in one call
    (the dense scan, which ``comm_stats`` does not account, ships ``W ·
    n² · M_max`` blocks, ``plan_lowering``'s count)."""
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


def test_tags_taken_out_of_order_arrive_bit_for_bit(ops):
    got = ops[1][0]["tags"]
    for tag in (1, 2, 3):
        assert torch.equal(got[tag], _draw((5, 7), tag, torch.bfloat16))


def test_a_tensor_larger_than_the_mailbox_arrives_in_pieces(ops):
    assert torch.equal(ops[1][0]["big"], _draw((3, BOX), 9))


def test_bf16_all_gather_and_broadcast_bit_for_bit(ops):
    for rank, (out, _) in enumerate(ops):
        assert out["transport"] == "DeviceTensorTransport"
        assert len(out["gather"]) == 4
        for r, t in enumerate(out["gather"]):
            assert t.dtype == torch.bfloat16
            assert torch.equal(t, _draw((6, 3), 20 + r, torch.bfloat16))
        pair = [rank % 2, rank % 2 + 2]
        for i, r in enumerate(pair):
            assert torch.equal(out["pair_gather"][i], _draw((2, 700), 30 + r))
        assert torch.equal(out["bcast"], _draw((9, 5), 42, torch.bfloat16))


@pytest.mark.parametrize("group", ["world", "pairs"])
def test_all_reduce_is_the_rank_order_tree_sum_on_every_member(ops, group):
    for rank, (out, _) in enumerate(ops):
        if group == "world":
            members, shape, seed, got = range(4), (3, 1000), 50, out["reduce"]
        else:
            members, shape, seed = (rank % 2, rank % 2 + 2), (1001,), 60
            got = out["pair_reduce"]
        parts = [_draw(shape, seed + m) for m in members]
        want = (parts[0] + parts[1] if len(parts) == 2 else
                (parts[0] + parts[1]) + (parts[2] + parts[3]))
        assert got.dtype == torch.float32
        assert torch.equal(got, want), rank
        assert float(out["scalar"]) == 6.0


def test_all_reduce_refuses_any_dtype_but_f32(ops):
    for out, _ in ops:
        assert "f32 only" in out["refused"]


def test_tensor_counts_and_clocks(ops):
    """Bytes and messages per peer by kind (a pair's all-reduce counts the
    tensor's bytes to each other member; a scalar is ``"scalar"``), nothing
    staged, the clocks read."""
    big, small = 3 * BOX * 4, 5 * 7 * 2
    for rank, (out, _) in enumerate(ops):
        peers = [p for p in range(4) if p != rank]
        mate = (rank + 2) % 4
        want = {k: [0] * 4 for k in ("p2p", "reduce", "gather", "scalar")}
        for p in peers:
            want["gather"][p] += 6 * 3 * 2
            want["reduce"][p] += 3 * 1000 * 4
            want["scalar"][p] += 4
        want["gather"][mate] += 2 * 700 * 4
        want["reduce"][mate] += 1001 * 4
        if rank == 0:
            want["p2p"][1] += 3 * small + big
        if rank == 2:
            for p in peers:
                want["p2p"][p] += 9 * 5 * 2
        assert out["bytes"] == want, rank
        assert out["msgs"]["p2p"][1] == {0: 4, 2: 1}.get(rank, 0)
        assert out["staged_bytes"] == 0
        assert out["ms"]["reduce"] >= 0.0 and out["busy_ms"] > 0.0


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(leaf_paths(a), leaf_paths(b)))


def test_tp2_serve_cell_equals_gloo_bit_for_bit(tp2_worlds):
    for dev, glo in zip(tp2_worlds["device"], tp2_worlds["gloo"]):
        assert dev["transport"] == "DeviceTensorTransport"
        assert glo["transport"] == "TensorTransport"
        assert torch.equal(dev["prefill"], glo["prefill"])
        for (tok, lg), (tok2, lg2) in zip(dev["steps"], glo["steps"]):
            assert torch.equal(tok, tok2) and torch.equal(lg, lg2)
        assert dev["serve_bytes"] == glo["serve_bytes"]
        assert torch.isfinite(dev["prefill"]).all()
    assert torch.equal(tp2_worlds["device"][0]["prefill"],
                       tp2_worlds["device"][1]["prefill"])


def test_tp2_train_steps_equal_gloo_bit_for_bit(tp2_worlds):
    for dev, glo in zip(tp2_worlds["device"], tp2_worlds["gloo"]):
        for m, m2 in zip(dev["metrics"], glo["metrics"]):
            assert set(m) == set(m2)
            assert all(torch.equal(m[k], m2[k]) for k in m), (m, m2)
        assert _same(dev["params"], glo["params"])
        assert dev["train_bytes"] == glo["train_bytes"]
    first = tp2_worlds["device"][0]["metrics"]
    assert float(first[1]["loss"]) < float(first[0]["loss"]) + 1.0


@pytest.mark.parametrize("how", ["raise", "kill", "hang"])
def test_a_rank_that_fails_mid_exchange_fails_the_world(how):
    """Rank 0 waits in the mailbox for rank 1's part of an all-reduce:
    rank 1's error, its death (``RankDied``) or, where it hangs, rank 0's
    poll deadline (the world's ``timeout``) ends the world."""
    timeout = 10 if how == "hang" else 120
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)) as err:
        ranks.spawn_ranks(fault_rank, 2, how, device="cpu", timeout=timeout,
                          transport="device", mailbox_bytes=BOX)
    if how == "kill":
        assert isinstance(err.value, ranks.RankDied) and err.value.ranks == [1]
    elif how == "raise":
        assert "fails on purpose" in str(err.value)
    assert time.monotonic() - t0 < timeout + 40     # + the teardown


def test_rank_children_import_no_jax_or_repro(ops):
    for _, modules in ops:
        assert "torch" in modules
        assert not {"jax", "jaxlib", "repro"} & set(modules), modules


def test_the_transport_is_the_worlds_and_refuses_what_it_does_not_take():
    """gloo is the CPU's default; a world on the device transport gives
    its executor and meshes the mailbox's transports; an unknown transport
    or a mailbox under 4 KiB raises before any rank starts."""
    got = ranks.spawn_ranks(kinds_rank, 2, device="cpu", timeout=120)
    assert got == [("HostTransport", "TensorTransport")] * 2
    got = ranks.spawn_ranks(kinds_rank, 2, device="cpu", timeout=120,
                            transport="device", mailbox_bytes=BOX)
    assert got == [("DeviceTransport", "DeviceTensorTransport")] * 2
    with pytest.raises(ValueError, match="transport 'nccl'"):
        ranks.spawn_ranks(kinds_rank, 2, device="cpu", transport="nccl")
    with pytest.raises(ValueError, match="at least 4096"):
        ranks.spawn_ranks(kinds_rank, 2, device="cpu", timeout=120,
                          transport="device", mailbox_bytes=1024)


def kinds_rank(rank, world, *, device):
    prog = gemm.gemm_2d_program(2, 1, 2, 4)
    ex = prog.executor(gemm.gemm_bodies(), device=device,
                       group=dist.group.WORLD)
    mesh = Mesh((1, 2), ("data", "model"), device, group=dist.group.WORLD)
    return type(ex.transport).__name__, type(mesh.transport).__name__
