"""The pipelined mesh's pipe and data axes on rank processes, on the CPU:
one spawned process per mesh coordinate, joined into a gloo group
(``launch.mesh.Mesh(..., group=)``, ``dist.ranks.TensorTransport``).

- ``pipeline_apply`` on 4 stage ranks, on the reference case of
  ``tests/test_torch_pipeline.py`` (4 stages, 8 microbatches of 4 x 16,
  ``tanh(x @ p)``): outputs to 1e-5 and gradients to rtol 1e-4 / atol
  1e-5 of ``repro``'s on 4 forced host devices (an ``.npz`` from this
  file's script mode: its jitted ``pipeline_apply`` and gradient on an
  Auto-axis ``jax.sharding.Mesh``), and bit for
  bit the port's logical ``pipeline_apply``; each rank runs its 8 stage
  calls in 8 wavefronts and sends only to its pair;
- ``pipeline_grads`` and ``make_pipeline_train_step`` on the reduced
  starcoder2-3b (4 layers, f32) on a (2, 1, 1) and a (2, 2, 1) world, with
  masked labels whose counts differ between the data ranks, and with tied
  embeddings on (2, 2, 1): the loss to 1e-6 relative and each gradient
  leaf to 1e-5 of its max|g| of the logical step's; two steps' loss and
  |g| likewise, and the first update of each weight whose gradient is not
  near 0 to LR / 1000; the bytes each rank sends each peer in a step, by
  kind, equal their formula;
- the checkpoint from the (2, 2, 1) ranks (``save_from_ranks``) is byte
  for byte the one-process ``save`` of the same state, each rank restores
  its own rows bit for bit, and ``repro``'s ``restore`` reads it;
- under ``launch_mesh`` a rank's context is its own mesh, its batch one
  dispatch row;
- a mesh off the world's size refuses to go on ranks; on a mesh of ranks
  with a model axis > 1 the pipelined trainer refuses (the reference's
  pipelined launcher runs with model axis 1), while serving runs there,
  the reduced seamless-m4t-large-v2 at a vocabulary of 510 that does not
  divide over 4 too (its embedding and head split on d_model: the
  one-process logits within 1e-5);
  ``launch.train --pipeline 2 --host-devices 2 --ranks --device cpu``
  lowers the loss, and refuses ``--ranks`` without ``--pipeline`` and
  with ``--elastic``.

The rank functions live here (a spawned child imports this module, which
imports nothing of JAX at its top). Each world is spawned once for the
module: one of 4 ranks, one of 2.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.dist import ctx, ranks
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.pipeline import pipeline_apply
from repro_torch.launch.mesh import Mesh, make_pipeline_mesh
from repro_torch.models.transformer import (abstract_params, forward,
                                            init_params)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import (make_pipeline_loss,
                                          make_pipeline_train_step,
                                          pipeline_grads, pipeline_rows,
                                          pipeline_shard, value_and_grads)
from repro_torch.train.tree import leaf_paths, tree_map, unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STAGES, N_MICRO, MB, D = 4, 8, 4, 16
# the train cells: 8 rows of 16 tokens, 2 microbatches on each data rank
ROWS, SEQ, MICRO, LR = 8, 16, 2, 1e-3


def _inputs():
    """``tests/test_torch_pipeline.py``'s inputs (the same seed and draws)."""
    rng = np.random.default_rng(0)
    params = (rng.standard_normal((N_STAGES, D, D)) * D ** -0.5).astype(
        np.float32)
    xs = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    ys = rng.standard_normal((N_MICRO * MB, D)).astype(np.float32)
    return params, xs, ys


def _stage(p, x):
    return torch.tanh(x @ p)


def _cfg(tie=False):
    return reduced(get_config("starcoder2-3b"), n_layers=4, vocab_size=128,
                   compute_dtype="float32", tie_embeddings=tie)


def _batch():
    """Labels masked unequally: 13 in data rank 0's rows, 3 in rank 1's."""
    b = SyntheticLM(128, SEQ, ROWS, learnable=True, seed=3).batch_at(0)
    b["labels"][0, ::3] = -1
    b["labels"][1, :7] = -1
    b["labels"][6, ::7] = -1
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ------------------------------------------------------ rank functions

def dshard_forward_under(mesh, device) -> float:
    """``forward`` of the reduced seamless-m4t-large-v2 at a vocabulary of
    510, which a model axis of 4 does not divide (the embedding and head
    split on d_model), on this rank's shard of its seed-0 weights under
    ``mesh`` as the serving launcher installs it: max|ranked - one
    process| / max|one process| of its logits."""
    cfg = reduced(get_config("seamless-m4t-large-v2"), vocab_size=510,
                  compute_dtype="float32")
    gen = torch.Generator().manual_seed(4)
    kw = {"tokens": torch.randint(0, 510, (ROWS, SEQ), generator=gen),
          "enc_embeds": torch.randn((ROWS, SEQ, cfg.d_model), generator=gen)}
    params = tp.init_shard_params(cfg, mesh, seed=0, device=device)
    with torch.inference_mode():
        with ctx.launch_mesh(mesh, global_batch=ROWS):
            got = forward(cfg, params, **kw)[0]
        want = forward(cfg, init_params(cfg, seed=0, device=device), **kw)[0]
    return float((got - want).abs().max() / want.abs().max())


def apply_rank(rank, world, *, device):
    """The reference case on this rank's stage: its output (last stage),
    its parameter's gradient, its counts and bytes; then the refusals."""
    params, xs, ys = map(torch.from_numpy, _inputs())
    mesh = Mesh((world,), ("pipe",), device, group=dist.group.WORLD)
    p = params[rank].clone().requires_grad_()
    x = xs if rank == 0 else torch.empty(xs.shape, dtype=xs.dtype,
                                         device="meta")
    pipeline_apply.stage_calls = pipeline_apply.wavefronts = 0
    out = pipeline_apply(_stage, p, x, mesh=mesh)
    calls = (pipeline_apply.stage_calls, pipeline_apply.wavefronts)
    last = rank == world - 1
    objective = (torch.mean((out.reshape(ys.shape) - ys) ** 2) if last
                 else out)
    grad, = torch.autograd.grad(objective, [p])
    refused = []
    try:
        Mesh((world // 2,), ("pipe",), device, group=dist.group.WORLD)
    except ValueError as exc:
        refused.append(str(exc))
    # a model axis lies on ranks; the pipeline on it refuses, serving runs
    tp_mesh = Mesh((1, 1, world), ("pipe", "data", "model"), device,
                   group=dist.group.WORLD)
    for attempt in (
            lambda: make_pipeline_train_step(_cfg(), tp_mesh, lr=LR,
                                             n_micro=MICRO),
            lambda: pipeline_apply(_stage, p, xs, mesh=tp_mesh)):
        try:
            attempt()
        except ValueError as exc:
            refused.append(str(exc))
    refused.append(dshard_forward_under(tp_mesh, device))
    return {"out": out.detach() if last else None, "grad": grad,
            "calls": calls, "bytes": mesh.transport.bytes,
            "refused": refused}


def train_rank(rank, world, stages, tie, ckpt_dir, *, device):
    """This rank's loss and gradients (``pipeline_grads``), then two train
    steps from the same state: their metrics, the parameters after the
    first and the bytes sent in it; with ``ckpt_dir``, the state after the
    second saved from the ranks and restored from its own rows."""
    cfg, batch = _cfg(tie), _batch()
    mesh = make_pipeline_mesh(stages, world, device, group=dist.group.WORLD)
    params = pipeline_shard(cfg, init_params(cfg, seed=0, device=device),
                            mesh)
    loss, grads = pipeline_grads(cfg, mesh, n_micro=MICRO)(params, batch)
    step = make_pipeline_train_step(cfg, mesh, lr=LR, n_micro=MICRO)
    mesh.transport.reset()
    params, opt, first = step(params, adamw_init(params), batch)
    sent = {k: list(v) for k, v in mesh.transport.bytes.items()}
    after = tree_map(torch.clone, params)
    params, opt, second = step(params, opt, batch)
    state = {"params": params, "opt": opt}
    rows = pipeline_rows(cfg, state, mesh)
    restored = None
    if ckpt_dir:
        like = abstract_params(cfg)
        ckpt.save_from_ranks(
            ckpt_dir, 1, state if mesh.coords["data"] == 0 else None,
            like={"params": like, "opt": adamw_init(like)}, rows=rows)
        back = ckpt.restore(ckpt_dir, 1, state, rows=rows)
        restored = all(torch.equal(a, b) for (_, a), (_, b) in
                       zip(leaf_paths(back), leaf_paths(state)))
    x = torch.ones(ROWS, SEQ, 4)
    with ctx.launch_mesh(mesh, global_batch=ROWS, seq_len=SEQ):
        seen = (ctx.get_mesh() is mesh, ctx.batch_axes(), ctx.data_rows(),
                ctx.annotate(x, ctx.act_spec()) is x)
    return {"coords": mesh.coords, "loss": loss, "grads": grads,
            "grad_rows": pipeline_rows(cfg, grads, mesh),
            "metrics": [first, second], "after": after, "state": state,
            "rows": rows,
            "bytes": sent, "restored": restored, "ctx": seen}


# ------------------------------------------------------------- worlds

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 4-rank world (the reference case; (2, 2, 1) untied with a
    checkpoint, and tied) and the 2-rank world ((2, 1, 1))."""
    ck = str(tmp_path_factory.mktemp("ranked_ckpt"))
    four = ranks.spawn_ranks(ranks.run_jobs, 4, [
        (apply_rank, (), {}), (train_rank, (2, False, ck), {}),
        (train_rank, (2, True, None), {})], device="cpu", timeout=300)
    two = ranks.spawn_ranks(train_rank, 2, 2, False, None, device="cpu",
                            timeout=300)
    return {"apply": [r[0] for r in four], (2, 2, False): [r[1] for r in four],
            (2, 2, True): [r[2] for r in four], (2, 1, False): two,
            "ckpt": ck}


def _write_reference(path):
    """``repro``'s ``pipeline_apply`` and the gradient of its
    ``pipeline_loss_fn`` on the reference case, on 4 host devices, jitted
    (this file's script mode)."""
    import jax
    import jax.numpy as jnp

    from repro.dist import pipeline as jx_pipe

    params, xs, batch_y = map(jnp.asarray, _inputs())
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:N_STAGES]), ("pipe",))

    def stage_fn(p, x):
        return jnp.tanh(x @ p)

    loss = jx_pipe.pipeline_loss_fn(
        stage_fn, lambda yh, y: jnp.mean((yh - y) ** 2), mesh=mesh,
        n_micro=N_MICRO)

    def both(p, x, y):
        return (jx_pipe.pipeline_apply(stage_fn, p, x, mesh=mesh),
                jax.grad(loss)(p, x.reshape(N_MICRO * MB, D), y))

    with mesh:
        ys, grads = jax.jit(both)(params, xs, batch_y)
    np.savez(path, ys=np.asarray(ys), grads=np.asarray(grads))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s outputs and gradients of the reference case, from this
    file's script mode on 4 forced host devices."""
    path = tmp_path_factory.mktemp("jax_pipeline") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# --------------------------------------------------------- pipeline_apply

def test_ranked_pipeline_apply_matches_reference_and_logical(worlds,
                                                              reference):
    runs = worlds["apply"]
    params, xs, ys = map(torch.from_numpy, _inputs())
    p = params.clone().requires_grad_()
    out = pipeline_apply(_stage, p, xs, mesh=Mesh((N_STAGES,), ("pipe",),
                                                  "cpu"))
    torch.mean((out.reshape(ys.shape) - ys) ** 2).backward()
    got = runs[-1]["out"]
    np.testing.assert_allclose(got.numpy(), reference["ys"], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, out.detach())
    for r, run in enumerate(runs):
        np.testing.assert_allclose(run["grad"].numpy(),
                                   reference["grads"][r], rtol=1e-4,
                                   atol=1e-5)
        assert torch.equal(run["grad"], p.grad[r]), r
        assert run["calls"] == (N_MICRO, N_MICRO)      # its own tasks only
        assert runs[r]["out"] is None or r == N_STAGES - 1


def test_ranked_pipeline_sends_only_to_its_pair(worlds):
    """Each stage sends its 8 activations to the next stage and their 8
    gradients back to the previous one, nothing else."""
    block = MB * D * 4
    for r, run in enumerate(worlds["apply"]):
        want = [0] * N_STAGES
        if r < N_STAGES - 1:
            want[r + 1] += N_MICRO * block
        if r:
            want[r - 1] += N_MICRO * block
        assert run["bytes"]["p2p"] == want, r
        assert not any(run["bytes"]["reduce"] + run["bytes"]["scalar"])


def test_a_mesh_off_the_world_or_with_a_model_axis_refuses_ranks(worlds):
    """A mesh off the world's size refuses to go on ranks. A model axis of
    4 goes on them, and the pipeline on it refuses: the pipelined train
    step and ``pipeline_apply`` (the reference's pipelined launcher runs
    with model axis 1; a model axis trains on ranks without the pipeline).
    Serving runs on it, also where it does not divide the vocabulary,
    which it refused until the d_model-sharded embedding and head (ROADMAP
    A8d5b): the reduced seamless-m4t-large-v2 at 510."""
    for run in worlds["apply"]:
        off, step, apply, vocab = run["refused"]
        assert "whole world of 2 processes, got 4" in off
        for msg in (step, apply):
            assert "model axis 4 on ranks" in msg
            assert "pipelined launcher runs with model axis 1" in msg
        assert vocab <= 1e-5


# ---------------------------------------------------------- training

def _logical(cfg, stages, data):
    """The logical step's loss and gradients on the same batch,
    microbatches of the same rows, then two steps: their metrics and the
    parameters after the first."""
    mesh = make_pipeline_mesh(stages, stages * data, "cpu")
    batch = _batch()
    params = init_params(cfg, seed=0, device="cpu")
    loss, grads = value_and_grads(
        make_pipeline_loss(cfg, mesh, n_micro=MICRO * data), params, batch)
    step = make_pipeline_train_step(cfg, mesh, lr=LR, n_micro=MICRO * data)
    params, opt, first = step(params, adamw_init(params), batch)
    after = tree_map(torch.clone, params)
    _, _, second = step(params, opt, batch)
    return loss, grads, [first, second], after


def _part(whole, name, row, like):
    """``like``'s part of the whole leaf ``name``."""
    t = dict(leaf_paths(whole))[name]
    return t[row:row + like.shape[0]] if like.dim() and row is not None \
        and "dense" in name.split("/") else t


CELLS = [(2, 1, False), (2, 2, False), (2, 2, True)]


@pytest.mark.parametrize("cell", CELLS, ids=["pipe2", "pipe2-dp2",
                                              "pipe2-dp2-tied"])
def test_ranked_loss_and_grads_match_logical(worlds, cell):
    stages, data, tie = cell
    loss, grads, _, _ = _logical(_cfg(tie), stages, data)
    for run in worlds[cell]:
        assert abs(float(run["loss"]) - float(loss)) <= 1e-6 * float(loss)
        for name, g in leaf_paths(run["grads"]):
            w = _part(grads, name, run["grad_rows"][name], g)
            assert g.shape == w.shape and g.dtype == w.dtype, name
            err = float((g - w).abs().max() / w.abs().max().clamp(
                min=1e-30))
            assert err <= 1e-5, (cell, run["coords"], name, err)


@pytest.mark.parametrize("cell", CELLS, ids=["pipe2", "pipe2-dp2",
                                              "pipe2-dp2-tied"])
def test_ranked_step_matches_logical_step(worlds, cell):
    """Two steps: each step's loss to 1e-6 and |g| to 1e-5 relative of the
    logical step's (the second's are taken at the parameters the first
    update wrote), and each weight's first update to LR / 1000 of the
    logical one wherever the logical gradient exceeds 1e-5 of its leaf's
    max|g|: AdamW's first step moves a weight by lr·g/(|g| + eps), so
    only near g = 0 may a gradient that differs by rounding turn it."""
    stages, data, tie = cell
    _, grads, metrics, params = _logical(_cfg(tie), stages, data)
    for run in worlds[cell]:
        for got, want in zip(run["metrics"], metrics):
            assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-6 \
                * float(want["loss"]), run["coords"]
            assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) \
                <= 1e-5 * float(want["grad_norm"]), run["coords"]
        assert int(run["state"]["opt"].step) == 2
        for name, p in leaf_paths({"params": run["after"]}):
            row = run["rows"][name]
            w = _part({"params": params}, name, row, p)
            g = _part({"params": grads}, name, row, p).abs()
            moved = g > 1e-5 * g.max()
            err = float(((p - w).abs() * moved).max())
            assert moved.any() and err <= LR * 1e-3, (name, err)


@pytest.mark.parametrize("cell", CELLS, ids=["pipe2", "pipe2-dp2",
                                              "pipe2-dp2-tied"])
def test_ranked_step_bytes_per_peer(worlds, cell):
    """One step: each hand-off (S·D f32 per row, every row of the data
    rank, once each way), each f32 gradient leaf once to the data peer, a
    tied embedding once to the other end of the pipe; scalars apart: the
    mask count and the loss in the last stage's data group, the loss from
    the last stage to the first, the |g|² both ways."""
    stages, data, tie = cell
    runs = worlds[cell]
    handoff = ROWS // data * SEQ * _cfg(tie).d_model * 4
    rank_at = {tuple(r["coords"].values()): i for i, r in enumerate(runs)}
    for run in runs:
        s, d = run["coords"]["pipe"], run["coords"]["data"]
        other = rank_at[(1 - s, d, 0)]
        p2p, reduce, scalar = ([0] * len(runs) for _ in range(3))
        p2p[other] = handoff
        if data > 1:
            reduce[rank_at[(s, 1 - d, 0)]] = sum(
                g.nbytes for g in dict(leaf_paths(run["grads"])).values())
            if s == 1:
                scalar[rank_at[(s, 1 - d, 0)]] = 8     # count, loss
        if tie:
            reduce[other] = run["grads"]["embed"].nbytes
        scalar[other] = 8 if s == 1 else 4           # (loss), |g|²
        assert run["bytes"] == {"p2p": p2p, "reduce": reduce,
                                "gather": [0] * len(runs),
                                "scalar": scalar}, (cell, run["coords"])


def test_rank_sees_its_own_mesh_in_the_context(worlds):
    """Under ``launch_mesh`` a rank's ambient mesh is its own (with its
    coordinates); the batch shards over "data"; its batch is one
    dispatch row; ``annotate`` returns its input."""
    for run in worlds[(2, 2, False)]:
        assert run["ctx"] == (True, "data", 1, True), run["coords"]


# -------------------------------------------------------- checkpoints

def _assemble(cfg, runs):
    """The whole state of the data-rank-0 ranks' parts."""
    like = abstract_params(cfg)
    like = {"params": like, "opt": adamw_init(like)}
    whole = {name: torch.zeros(t.shape, dtype=t.dtype)
             for name, t in leaf_paths(like)}
    for run in runs:
        if run["coords"]["data"] == 0:
            for name, t in leaf_paths(run["state"]):
                if t.dim():
                    row = run["rows"][name]
                    whole[name][row:row + t.shape[0]] = t
                else:
                    whole[name].copy_(t)
    return unflatten(like, [whole[name] for name, _ in leaf_paths(like)])


def test_ranked_checkpoint_is_the_one_process_save(worlds):
    runs = worlds[(2, 2, False)]
    assert all(run["restored"] for run in runs)
    state = _assemble(_cfg(), runs)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, state)
        got = os.path.join(worlds["ckpt"], "step_00000001")
        want = os.path.join(d, "step_00000001")
        names = sorted(os.listdir(os.path.join(want, "arrays")))
        assert sorted(os.listdir(os.path.join(got, "arrays"))) == names
        for f in ["manifest.json"] + [os.path.join("arrays", n)
                                      for n in names]:
            with open(os.path.join(got, f), "rb") as a, \
                    open(os.path.join(want, f), "rb") as b:
                assert a.read() == b.read(), f


def test_reference_restores_the_ranked_checkpoint(worlds):
    import jax

    from repro.configs import base as jx_base
    from repro.configs.registry import get_config as jx_get_config
    from repro.models import transformer as jx_tfm
    from repro.train import checkpoint as jx_ckpt
    from repro.train.optimizer import adamw_init as jx_adamw_init

    jcfg = jx_base.reduced(jx_get_config("starcoder2-3b"), n_layers=4,
                           vocab_size=128, compute_dtype="float32")
    like = jx_tfm.init_params(jcfg, jax.random.key(1))
    out = jx_ckpt.restore(worlds["ckpt"], 1, {"params": like,
                                               "opt": jx_adamw_init(like)})
    state = _assemble(_cfg(), worlds[(2, 2, False)])
    got, want = jax.tree.leaves(out), [t for _, t in leaf_paths(state)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ----------------------------------------------------------- launcher

def _train(*args):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", "starcoder2-3b", "--reduced",
                           "--device", "cpu", *args], capture_output=True,
                          text=True, timeout=600, cwd=REPO, env=env)


def test_train_launcher_on_ranks(tmp_path):
    proc = _train("--pipeline", "2", "--host-devices", "2", "--ranks",
                  "--steps", "12", "--global-batch", "8", "--seq", "32",
                  "--lr", "2e-3", "--ckpt-dir", str(tmp_path / "ck"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "mesh: {'pipe': 2, 'data': 1, 'model': 1} on 2 rank processes" \
        in out
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 3 and losses[-1] < losses[0], out
    assert out.rstrip().endswith("done")
    assert ckpt.latest_step(str(tmp_path / "ck")) == 11


@pytest.mark.parametrize("args,message", [
    (("--ranks",), "A8d"),
    # (the reference's message since --elastic runs on ranks, ROADMAP A8e;
    # the case keeps its name)
    pytest.param(("--ranks", "--pipeline", "2", "--elastic"),
                 "--elastic does not compose with --pipeline yet",
                 id="args1-A8e"),
    (("--ranks", "--pipeline", "2", "--host-devices", "3"),
     "does not divide 3 devices")])
def test_train_launcher_refuses_on_ranks(args, message):
    proc = _train(*args)
    assert proc.returncode != 0 and message in proc.stderr, proc.stderr


if __name__ == "__main__":
    _write_reference(sys.argv[1])
