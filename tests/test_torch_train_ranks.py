"""Training with a model axis on rank processes, on the CPU: the ("data",
"model") mesh laid on spawned processes joined into a gloo group
(``make_train_step(cfg, mesh=)``, ``dist.tensor_parallel``'s collectives
with their backward).

Four cells, f32 compute, each from ``repro``'s seed-0 parameters: the
reduced starcoder2-3b on (1, 4) (``kv_head_pad`` 2: each rank holds a
whole KV head, shared with one other rank), yi-6b on (1, 2), qwen3-14b on
(1, 4) (its ``q_norm``/``k_norm`` replicated, read by head-sharded q and
k) and llava-next-34b on (2, 2) (vlm, fed embeds; a data axis), once
more in 2 microbatches. Labels are masked unequally between the data
ranks and between the microbatches.

- two steps' losses (1e-6 relative) and |g| (1e-5) against the
  one-process port step, and against ``repro``'s jitted ``make_train_step``
  with params and optimizer state placed by its specs on an Auto-axis
  ``jax.sharding.Mesh`` of the cell's shape over 4 forced host devices (an
  ``.npz`` from this file's script mode; 1e-5);
- each rank's gradient of every leaf against its box of the one-process
  gradient (1e-5 of the leaf's largest), and the first update of every
  weight whose gradient is not near 0 to LR / 1000 of the one-process
  update and of ``repro``'s (``tests/test_torch_pipeline_ranks.py``'s
  rule);
- the ranks that hold the same box of a leaf (KV heads, norms, the data
  axis) hold the same bits after the steps; which leaves the sharded
  region shares, from the spec tree and the model code;
- the bytes a rank sends each peer in a step, by kind, equal their formula;
- a hand-made gradient check of ``copy_to_model`` (f) and the model sum
  (g) on 2 ranks (``gradcheck`` in f64, a transport that sums in f64);
- the (2, 2) world's ``RankCheckpointer`` directory is byte for byte the
  one-process ``save`` of the whole state; restored onto (1, 4) and (1, 2)
  each rank reads its own boxes bit for bit, and the next step from them
  is bit for bit the step from the same state sharded in memory;
- the launcher trains on 4 rank processes (the reference's lines, the
  loss of the logical run's), also the ssm, hybrid and encdec families,
  and everything a model axis on ranks does not train refuses, naming
  its ROADMAP item or what does not divide (the moe family and Adafactor
  train there: ``tests/test_torch_moe_train_ranks.py``; the ssm, hybrid
  and encdec families and the d_model-sharded head:
  ``tests/test_torch_ssm_train_ranks.py``).

The rank functions live here (a spawned child imports this module, which
imports nothing of JAX at its top). Each world is spawned once for the
module: one of 4 ranks, one of 2.
"""

import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.dist import ranks
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.ctx import use_mesh
from repro_torch.dist.pipeline import refuse_model_axis
from repro_torch.launch.mesh import Mesh
from repro_torch.models.convert import (params_from_reference,
                                        shard_params_from_reference)
from repro_torch.models.transformer import abstract_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import (_accumulate, _split,
                                          loss_and_grads, make_train_step,
                                          pipeline_adafactor_shards,
                                          ranked_grads, replica_leaves)
from repro_torch.train.tree import leaf_paths, tree_map, unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, SEQ, LR, STEP = 4, 16, 1e-3, 2        # STEP: the checkpoint's step
# cell -> (arch, data, model)
CELLS = {"starcoder2-tp4": ("starcoder2-3b", 1, 4),
         "yi-tp2": ("yi-6b", 1, 2),
         "qwen3-tp4": ("qwen3-14b", 1, 4),
         "llava-dp2-tp2": ("llava-next-34b", 2, 2),
         "llava-dp2-tp2-mb2": ("llava-next-34b", 2, 2)}
MICRO = {"llava-dp2-tp2-mb2": 2}     # cell -> microbatches (default 1)
ARCHS = sorted({arch for arch, _, _ in CELLS.values()})
CKPT_ARCH = "llava-next-34b"


def _cfg(arch):
    return reduced(get_config(arch), compute_dtype="float32")


def _batch(cfg, step):
    """Batch ``step`` (numpy): ``SyntheticLM``'s tokens (embeds for the
    vlm) and labels, 13 masked in rows 0-1 and 4 in rows 2-3."""
    b = SyntheticLM(cfg.vocab_size, SEQ, ROWS, seed=5,
                    embed_dim=cfg.d_model if cfg.embed_inputs else None
                    ).batch_at(step)
    b["labels"] = b["labels"].copy()        # a view of the tokens' array
    b["labels"][0, ::3] = -1
    b["labels"][1, :7] = -1
    b["labels"][3, ::4] = -1
    return b


def _torch(b, device="cpu"):
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in b.items()}


def _unflat(items):
    tree = {}
    for name, v in items.items():
        *path, last = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _reference_tree(path, arch):
    """``repro``'s seed-0 parameters of ``arch`` (numpy) from the
    ``.npz``."""
    with np.load(path) as f:
        return _unflat({k.split("/", 1)[1]: f[k] for k in f.files
                        if k.startswith(f"params-{arch}/")})


def _state_like(cfg):
    like = abstract_params(cfg)
    return {"params": like, "opt": adamw_init(like)}


# ------------------------------------------------------ rank functions

def train_cell(rank, world, ref_path, cell, ckpt_dir, *, device):
    """One cell on this rank: its shard of ``repro``'s parameters, the
    ranked loss and gradients on batch 0, then two steps (batches 0 and 1):
    their metrics, the parameters after the first, the bytes sent in it and
    the state after the second; with ``ckpt_dir``, that state saved from
    the ranks as the launcher saves it."""
    arch, data, model = CELLS[cell]
    cfg = _cfg(arch)
    mesh = Mesh((data, model), ("data", "model"), device,
                group=dist.group.WORLD)
    params = shard_params_from_reference(
        cfg, _reference_tree(ref_path, arch), mesh, device)
    b0, b1 = (_torch(_batch(cfg, s), device) for s in (0, 1))
    mb = MICRO.get(cell, 1)
    loss, grads = ranked_grads(cfg, mesh, microbatches=mb)(params, b0)
    step = make_train_step(cfg, lr=LR, microbatches=mb, mesh=mesh)
    mesh.transport.reset()
    params, opt, first = step(params, adamw_init(params), b0)
    sent = {k: list(v) for k, v in mesh.transport.bytes.items()}
    after = tree_map(torch.clone, params)
    params, opt, second = step(params, opt, b1)
    state = {"params": params, "opt": opt}
    if ckpt_dir:
        like = _state_like(cfg)
        ckpt.RankCheckpointer(
            ckpt_dir, like=like, rows=tp.shard_boxes(cfg, like, mesh),
            writes=(tp.owned(cfg, like, mesh) if mesh.coords["data"] == 0
                    else False)).save(STEP, state)
    return {"coords": mesh.coords, "loss": loss, "grads": grads,
            "metrics": [first, second], "after": after, "state": state,
            "boxes": tp.shard_boxes(cfg, _state_like(cfg), mesh),
            "bytes": sent}


def restore_cell(rank, world, ckpt_dir, data, model, *, device):
    """The (2, 2) checkpoint restored onto a (data, model) mesh: each
    rank's boxes (``restore(..., rows=)``) against the same boxes of the
    whole state read on one process and sharded in memory, then one step
    (batch 2) from each: whether the restored shards, the states after the
    step and its metrics are bit for bit the same."""
    cfg = _cfg(CKPT_ARCH)
    mesh = Mesh((data, model), ("data", "model"), device,
                group=dist.group.WORLD)
    like = _state_like(cfg)
    boxes = tp.shard_boxes(cfg, like, mesh)
    got = ckpt.restore(ckpt_dir, STEP, tp.shard_tree(cfg, like, mesh),
                       device=device, rows=boxes)
    whole = ckpt.restore(ckpt_dir, STEP, like, device=device)
    want = tree_map(torch.clone, tp.shard_tree(cfg, whole, mesh))
    same = _same(got, want)
    step = make_train_step(cfg, lr=LR, mesh=mesh)
    batch = _torch(_batch(cfg, 2), device)
    p1, o1, m1 = step(got["params"], got["opt"], batch)
    p2, o2, m2 = step(want["params"], want["opt"], batch)
    return {"coords": mesh.coords, "restored": same,
            "next": _same((p1, o1), (p2, o2)) and all(
                torch.equal(m1[k], m2[k]) for k in m1)}


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(leaf_paths(a), leaf_paths(b)))


class _F64:
    """A transport whose all-reduce sums any dtype (f64 here) over gloo."""

    @staticmethod
    def all_reduce(t, group, kind="reduce"):
        dist.all_reduce(t, group=group)
        return t


def gradcheck_cell(rank, world, *, device):
    """``gradcheck`` in f64 of a tensor-parallel MLP, F(x) = tanh(g(tanh(
    f(x) @ A_r) @ B_r)), A_r this rank's columns of A and B_r its rows of
    B: f's backward sums the input's gradient over the group and g's is
    the identity, so F is tanh(tanh(x @ A) @ B) on every rank, and so is
    its Jacobian. (Only x, which every rank holds: a rank's A_r is another
    parameter than its peer's, which gradcheck would perturb at the same
    time.)"""
    mesh = Mesh((1, world), ("data", "model"), device,
                group=dist.group.WORLD)
    mesh.transport = _F64()
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(3, 5, dtype=torch.float64, generator=gen)
    a = torch.randn(5, 4 * world, dtype=torch.float64, generator=gen)
    b = torch.randn(4 * world, 6, dtype=torch.float64, generator=gen)
    a_r, b_r = a[:, 4 * rank:4 * (rank + 1)], b[4 * rank:4 * (rank + 1)]

    def mlp(x):
        return torch.tanh(tp._sum(mesh, torch.tanh(tp.copy_to_model(x)
                                                   @ a_r) @ b_r))

    with use_mesh(mesh):
        ok = torch.autograd.gradcheck(mlp, (x.clone().requires_grad_(),))
        out = mlp(x.clone().requires_grad_())
    return {"ok": ok, "out": out.detach(),
            "want": torch.tanh(torch.tanh(x @ a) @ b)}


# ------------------------------------------------------------- worlds

def _write_reference(path):
    """``repro``'s seed-0 parameters of each arch and, per cell, its jitted
    ``make_train_step`` twice (batches 0 and 1) with params, optimizer
    state and batch placed by its specs on an Auto-axis mesh of the cell's
    shape over the 4 host devices, as its launcher places them: the
    metrics and the parameters after the first step (this file's script
    mode)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.configs import base as jx_base
    from repro.configs.registry import get_config as jx_get_config
    from repro.dist import ctx as jx_ctx
    from repro.dist import sharding as jx_sh
    from repro.models import transformer as jx_tfm
    from repro.train.optimizer import adamw_init as jx_adamw_init
    from repro.train.optimizer import opt_state_specs
    from repro.train.train_step import make_train_step as jx_step

    out = {}
    jcfgs = {arch: jx_base.reduced(jx_get_config(arch),
                                   compute_dtype="float32") for arch in ARCHS}
    for arch, jcfg in jcfgs.items():
        jp = jx_tfm.init_params(jcfg, jax.random.key(0))
        for name, a in leaf_paths(jax.tree.map(np.asarray, jp)):
            out[f"params-{arch}/{name}"] = a
    for cell, (arch, data, model) in CELLS.items():
        jcfg = jcfgs[arch]
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:data * model]).reshape(data, model),
            ("data", "model"))
        axes = jx_sh.batch_axis(mesh, ROWS)
        jx_ctx.set_batch_axes(axes)
        jx_ctx.set_seq_shard(SEQ % model == 0)
        try:
            with jx_ctx.use_mesh(mesh):
                p_abs = jx_tfm.abstract_params(jcfg)
                p_specs = jx_sh.sanitize_specs(
                    jx_sh.param_specs(jcfg, model_axis=model), p_abs, mesh)
                o_abs = jax.eval_shape(jx_adamw_init, p_abs)
                o_specs = jx_sh.sanitize_specs(
                    opt_state_specs(p_specs, "adamw", p_abs), o_abs, mesh)
                params = jax.device_put(
                    jx_tfm.init_params(jcfg, jax.random.key(0)),
                    jx_sh.named_shardings(mesh, p_specs))
                opt = jax.device_put(jx_adamw_init(params),
                                     jx_sh.named_shardings(mesh, o_specs))
                step = jax.jit(jx_step(jcfg, lr=LR,
                                       microbatches=MICRO.get(cell, 1)))
                for s in (0, 1):
                    b = {k: jax.device_put(jnp.asarray(v), NamedSharding(
                        mesh, JP(axes))) for k, v in _batch(
                            _cfg(arch), s).items()}
                    params, opt, m = step(params, opt, b)
                    out[f"{cell}/loss{s}"] = np.asarray(m["loss"])
                    out[f"{cell}/grad_norm{s}"] = np.asarray(m["grad_norm"])
                    if s == 0:
                        for name, a in leaf_paths(jax.tree.map(np.asarray,
                                                               params)):
                            out[f"{cell}/after/{name}"] = a
        finally:
            jx_ctx.set_batch_axes(None)
            jx_ctx.set_seq_shard(False)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s outputs, from this file's script mode on 4 forced host
    devices; ``path`` is the ``.npz`` the ranks read the weights from."""
    path = tmp_path_factory.mktemp("jax_train_ranks") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as data:
        return {"path": str(path), **{k: data[k] for k in data.files}}


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """The 4-rank world (starcoder2 and qwen3 on (1, 4), llava on (2, 2)
    with its checkpoint, restored onto (1, 4)) and the 2-rank world (yi on
    (1, 2), the checkpoint restored onto (1, 2), the gradient check)."""
    ck = str(tmp_path_factory.mktemp("ranked_train_ckpt"))
    path = reference["path"]
    four = ranks.spawn_ranks(ranks.run_jobs, 4, [
        (train_cell, (path, "starcoder2-tp4", None), {}),
        (train_cell, (path, "qwen3-tp4", None), {}),
        (train_cell, (path, "llava-dp2-tp2", ck), {}),
        (train_cell, (path, "llava-dp2-tp2-mb2", None), {}),
        (restore_cell, (ck, 1, 4), {})], device="cpu", timeout=300)
    two = ranks.spawn_ranks(ranks.run_jobs, 2, [
        (train_cell, (path, "yi-tp2", None), {}),
        (restore_cell, (ck, 1, 2), {}),
        (gradcheck_cell, (), {})], device="cpu", timeout=300)
    return {"starcoder2-tp4": [r[0] for r in four],
            "qwen3-tp4": [r[1] for r in four],
            "llava-dp2-tp2": [r[2] for r in four],
            "llava-dp2-tp2-mb2": [r[3] for r in four],
            "restore-tp4": [r[4] for r in four],
            "yi-tp2": [r[0] for r in two],
            "restore-tp2": [r[1] for r in two],
            "gradcheck": [r[2] for r in two], "ckpt": ck}


@pytest.fixture(scope="module")
def one_process(reference):
    """Per cell, the one-process port on the same weights and batches: the
    loss and gradients on batch 0, the two steps' metrics and the
    parameters after the first."""
    out = {}
    for cell, (arch, _, _) in CELLS.items():
        cfg = _cfg(arch)
        params = params_from_reference(
            _reference_tree(reference["path"], arch), device="cpu")
        b0, b1 = (_torch(_batch(cfg, s)) for s in (0, 1))
        mb = MICRO.get(cell, 1)
        step = make_train_step(cfg, lr=LR, microbatches=mb)
        loss, grads = (loss_and_grads(cfg, params, b0) if mb == 1 else
                       _accumulate(cfg, params, _split(b0, mb), lambda b: b))
        params, opt, first = step(params, adamw_init(params), b0)
        after = tree_map(torch.clone, params)
        _, _, second = step(params, opt, b1)
        out[cell] = {"loss": loss, "grads": grads, "after": after,
                     "metrics": [first, second]}
    return out


def _box_of(whole, run, name):
    """``run``'s box of the whole leaf ``name`` (of a parameter tree)."""
    return dict(leaf_paths(whole))[name][run["boxes"][f"params/{name}"]]


# ------------------------------------------------------------ the step

@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_losses_and_norms_match_one_process_and_reference(
        worlds, one_process, reference, cell):
    want = one_process[cell]
    for run in worlds[cell]:
        assert abs(float(run["loss"]) - float(want["loss"])) \
            <= 1e-6 * float(want["loss"]), run["coords"]
        for s, (got, one) in enumerate(zip(run["metrics"], want["metrics"])):
            for key, tol in (("loss", 1e-6), ("grad_norm", 1e-5)):
                assert abs(float(got[key]) - float(one[key])) \
                    <= tol * float(one[key]), (s, key, run["coords"])
                ref = float(reference[f"{cell}/{key}{s}"])
                assert abs(float(got[key]) - ref) <= 1e-5 * ref, \
                    (s, key, run["coords"], float(got[key]), ref)


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_leaf_gradients_are_boxes_of_one_process(worlds, one_process,
                                                        cell):
    """Every leaf, the replicated norms, the shared KV heads and the
    vlm's untouched embedding (zeros) included."""
    grads = one_process[cell]["grads"]
    for run in worlds[cell]:
        for name, g in leaf_paths(run["grads"]):
            w = _box_of(grads, run, name)
            assert g.shape == w.shape and g.dtype == w.dtype, name
            err = float((g - w).abs().max())
            assert err <= 1e-5 * float(w.abs().max()), \
                (cell, run["coords"], name, err)


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_first_update_matches_one_process_and_reference(
        worlds, one_process, reference, cell):
    """Each weight's first update to LR / 1000 of the one-process one and
    of ``repro``'s wherever the one-process gradient exceeds 1e-5 of its
    leaf's max|g|: AdamW's first step moves a weight by lr·g/(|g| + eps),
    so only near g = 0 may a gradient that differs by rounding turn it."""
    want = one_process[cell]
    theirs = _unflat({k.split("/", 2)[2]: v for k, v in reference.items()
                      if k.startswith(f"{cell}/after/")})
    for run in worlds[cell]:
        assert int(run["state"]["opt"].step) == 2
        for name, p in leaf_paths(run["after"]):
            g = _box_of(want["grads"], run, name).abs()
            moved = g > 1e-5 * g.max()
            if not moved.any():          # the vlm's embedding: no gradient
                assert torch.equal(p, _box_of(want["after"], run, name))
                continue
            for w in (_box_of(want["after"], run, name),
                      torch.from_numpy(_box_of(theirs, run, name))):
                err = float(((p - w).abs() * moved).max())
                assert err <= LR * 1e-3, (cell, name, err)


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranks_holding_one_box_hold_the_same_bits(worlds, cell):
    """After the two steps the ranks that hold the same box of a leaf hold
    the same parameters and moments, bit for bit: the KV heads two ranks
    share, the replicated norms, every leaf across the data axis."""
    runs = worlds[cell]
    pairs = 0
    for i, a in enumerate(runs):
        for b in runs[i + 1:]:
            for name, t in leaf_paths(a["state"]):
                if a["boxes"][name] == b["boxes"][name]:
                    assert torch.equal(t, dict(leaf_paths(b["state"]))[name]
                                       ), (name, a["coords"], b["coords"])
                    pairs += 1
    assert pairs


@pytest.mark.parametrize("arch,model,want", [
    ("starcoder2-3b", 4, {"dense/attn/wk", "dense/attn/wv"}),
    ("qwen3-14b", 4, {"dense/attn/wk", "dense/attn/wv", "dense/attn/q_norm",
                      "dense/attn/k_norm"}),
    ("qwen3-14b", 2, {"dense/attn/q_norm", "dense/attn/k_norm"}),
    ("yi-6b", 2, set()), ("llava-next-34b", 2, set())])
def test_replica_leaves_come_from_the_specs_and_the_model(arch, model, want):
    """The leaves of the sharded region several ranks of a model line hold
    (their gradients summed over the holders): the KV heads
    ``kv_head_pad`` shares (pairs of ranks on 4 for 2 KV heads), the
    replicated ``q_norm``/``k_norm`` (the whole line); the replicated
    ``ln1``, ``ln2`` and ``final_norm`` lie outside the region."""
    cfg = _cfg(arch)
    for c in range(model):
        mesh = SimpleNamespace(shape={"data": 1, "model": model},
                               coords={"data": 0, "model": c})
        got = replica_leaves(cfg, mesh)
        assert set(got) == want, (c, got)
        for name, holders in got.items():
            pad = model if "norm" in name else 2
            assert holders == tuple(range(c // pad * pad,
                                          c // pad * pad + pad)), name


def test_copy_to_model_and_the_model_sum_pass_gradcheck(worlds):
    for run in worlds["gradcheck"]:
        assert run["ok"]
        torch.testing.assert_close(run["out"], run["want"], rtol=1e-12,
                                   atol=1e-12)


# --------------------------------------------------------------- bytes

@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_step_bytes_per_peer(worlds, cell):
    """One step, to each other rank of the model line (kind ``reduce``):
    the embedding's all-reduce (token cells), each layer's two forward
    all-reduces, the attention's again in the recomputed block (remat
    full; the recomputation stops at the last tensor the backward saved,
    before the FFN's) and two in the backward (the attention's and the
    FFN's input, Megatron's f), and the head's input: [rows, SEQ, d_model]
    f32 each; its f32 logits [rows, SEQ, V / model] (``gather``). To the
    data peer every gradient's f32 bytes (``grad``); to the other holders
    of a shared box of the sharded region its gradient (``replica``).
    Scalars: the loss to the data peer, |g|² to the model peers (each
    microbatch's label count is read off the global batch, not sent).
    Microbatches split the same rows, so the bytes are one batch's."""
    arch, data, model = CELLS[cell]
    cfg = _cfg(arch)
    runs = worlds[cell]
    rank_at = {tuple(r["coords"].values()): i for i, r in enumerate(runs)}
    rows = ROWS // data
    unit = rows * SEQ * cfg.d_model * 4
    per_step = (0 if cfg.embed_inputs else 1) + 5 * cfg.n_layers + 1
    for run in runs:
        d, c = run["coords"]["data"], run["coords"]["model"]
        model_peers = [rank_at[(d, m)] for m in range(model) if m != c]
        data_peers = [rank_at[(e, c)] for e in range(data) if e != d]
        want = {k: [0] * len(runs) for k in ("p2p", "reduce", "gather",
                                             "scalar", "grad", "replica")}
        grads = dict(leaf_paths(run["grads"]))
        for p in model_peers:
            want["reduce"][p] = per_step * unit
            want["gather"][p] = rows * SEQ * cfg.vocab_size // model * 4
            want["scalar"][p] = 4
        for p in data_peers:
            want["grad"][p] = sum(g.nbytes for g in grads.values())
            want["scalar"][p] = 4
        mesh = SimpleNamespace(shape={"data": data, "model": model},
                               coords=run["coords"])
        for name, holders in replica_leaves(cfg, mesh).items():
            for m in holders:
                if m != c:
                    want["replica"][rank_at[(d, m)]] += grads[name].nbytes
        if not any(want["replica"]):
            del want["replica"]
        if data == 1:
            del want["grad"]
        assert run["bytes"] == want, (cell, run["coords"])


# -------------------------------------------------------- checkpoints

def _assemble(cfg, runs):
    """The whole state of the data-rank-0 ranks' boxes."""
    like = _state_like(cfg)
    whole = {name: torch.zeros(t.shape, dtype=t.dtype)
             for name, t in leaf_paths(like)}
    for run in runs:
        if run["coords"]["data"] == 0:
            for name, t in leaf_paths(run["state"]):
                whole[name][run["boxes"][name]] = t
    return unflatten(like, [whole[name] for name, _ in leaf_paths(like)])


def test_ranked_checkpoint_is_the_one_process_save(worlds):
    state = _assemble(_cfg(CKPT_ARCH), worlds["llava-dp2-tp2"])
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, STEP, state)
        name = f"step_{STEP:08d}"
        got, want = (os.path.join(p, name) for p in (worlds["ckpt"], d))
        names = sorted(os.listdir(os.path.join(want, "arrays")))
        assert sorted(os.listdir(os.path.join(got, "arrays"))) == names
        for f in ["manifest.json"] + [os.path.join("arrays", n)
                                      for n in names]:
            with open(os.path.join(got, f), "rb") as a, \
                    open(os.path.join(want, f), "rb") as b:
                assert a.read() == b.read(), f


@pytest.mark.parametrize("where", ["restore-tp4", "restore-tp2"])
def test_ranked_checkpoint_restores_onto_another_mesh(worlds, where):
    for run in worlds[where]:
        assert run["restored"] and run["next"], run["coords"]


# ----------------------------------------------------------- launcher

def _train_arch(*args):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--device", "cpu", *args], capture_output=True,
                          text=True, timeout=600, cwd=REPO, env=env)


def _train(*args):
    return _train_arch("--arch", "starcoder2-3b", "--reduced",
                       "--host-devices", "4", "--steps", "3", *args)


def test_train_launcher_trains_a_model_axis_on_ranks(tmp_path):
    """The reference's lines: the mesh (the port's wording: where it
    lies), a step line at steps 0 and 2 and ``done``; the losses those of
    the logical (1, 4) run's lines within bf16's rounding of the products
    (the launcher's compute dtype; each rank rounds its own columns)."""
    lines = {}
    for how in ("ranks", "logical"):
        proc = _train(*(["--ranks"] if how == "ranks" else []),
                      "--ckpt-dir", str(tmp_path / how))
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines[how] = proc.stdout.splitlines()
    out = lines["ranks"]
    assert out[0].startswith("mesh: {'data': 1, 'model': 4} on 4 rank "
                             "processes (cpu), arch=starcoder2-3b ("), out[0]
    assert out[0].endswith(" seq=128 batch=8")
    assert lines["logical"][0].startswith(
        "mesh: {'data': 1, 'model': 4} (logical) on one device (cpu)")
    steps = [[ln.split() for ln in lines[how] if ln.startswith("step")]
             for how in ("ranks", "logical")]
    assert [s[1] for s in steps[0]] == [s[1] for s in steps[1]] == ["0", "2"]
    for got, want in zip(*steps):
        assert got[2] == "loss" and got[4] == "|g|" and got[7] == "tok/s"
        assert abs(float(got[3]) - float(want[3])) <= 1e-3 * float(want[3])
    assert out[-1] == "done"
    assert ckpt.latest_step(str(tmp_path / "ranks")) == 2


def _launcher_refuses(*args):
    from repro_torch.launch import train as launcher

    with pytest.raises(SystemExit) as exc:
        launcher.main(["--device", "cpu", "--steps", "1", "--ranks", *args])
    return str(exc.value.code)


def _pipeline_refuses():
    mesh = SimpleNamespace(group=object(), shape={"pipe": 2, "data": 1,
                                                  "model": 2})
    with pytest.raises(ValueError) as exc:
        refuse_model_axis(mesh)
    return str(exc.value)


def _pipelined_adafactor_trains():
    """The pipelined ranks' Adafactor (it refused until A8e): a stage's
    leaves of the layer stack split along the layers, summed over the
    pipe group; its other leaves whole (``pipeline_adafactor_shards``)."""
    cfg = reduced(get_config("yi-6b"), optimizer="adafactor")
    mesh = SimpleNamespace(shape={"pipe": 2, "data": 1, "model": 1},
                           coords={"pipe": 1, "data": 0, "model": 0})
    shards = pipeline_adafactor_shards(cfg, mesh)
    return "; ".join(f"{name} split {sorted(sh.split)}"
                     for name, sh in sorted(shards.items()))


def _launcher_trains(*args):
    """The launcher's output for one step on rank processes, where it used
    to refuse (the ssm, hybrid and encdec families, A8d6c)."""
    with tempfile.TemporaryDirectory() as ck:
        proc = _train_arch(*args, "--ranks", "--steps", "1",
                           "--global-batch", "4", "--seq", "16",
                           "--ckpt-dir", ck)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


class _Twice:
    """A stand-in model group of 2 ranks that hold the same slice: its
    all-reduce doubles, the sum of two equal terms."""

    @staticmethod
    def all_reduce(t, group, kind="reduce"):
        return t.mul_(2)


def _group_norm_grad_trains():
    """``group_rms_norm`` under grad (it refused until A8d6c), on a model
    group of 2 whose ranks hold equal slices x of a row [x, x]: its
    output and its gradients (of x and of its slice of the weight) are
    RMSNorm's over the whole row (in f64, as the group norm keeps a wider
    input's dtype), the upstream gradient [v, v]; the backward's sum over
    the group is what makes them so."""
    mesh = SimpleNamespace(group=object(), shape={"data": 1, "model": 2},
                           groups={"model": None}, transport=_Twice())
    gen = torch.Generator().manual_seed(9)
    x, w, v = (torch.randn(3, 8, generator=gen, dtype=torch.float64)
               for _ in range(3))
    x, w = x.requires_grad_(), w[0].requires_grad_()
    with use_mesh(mesh):
        out = tp.group_rms_norm(x, w)
    gx, gw = torch.autograd.grad(out, (x, w), v)
    xx, ww = (torch.cat([t, t], dim=-1).detach().requires_grad_()
              for t in (x, w))
    want = xx * torch.rsqrt((xx * xx).mean(-1, keepdim=True) + 1e-5) * ww
    wx, wv = torch.autograd.grad(want, (xx, ww), torch.cat([v, v], dim=-1))
    torch.testing.assert_close(out, want[..., :8], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gx, wx[..., :8], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gw, wv[:8], rtol=1e-12, atol=1e-12)
    return "group_rms_norm's gradient is RMSNorm's over the whole row"


@pytest.mark.parametrize("refuse,items", [
    (lambda: _launcher_trains("--arch", "mamba2-1.3b", "--reduced",
                              "--host-devices", "4"),
     ["mesh: {'data': 1, 'model': 4} on 4 rank processes", "done"]),
    (lambda: _launcher_trains("--arch", "zamba2-1.2b", "--reduced",
                              "--host-devices", "2"),
     ["mesh: {'data': 1, 'model': 2} on 2 rank processes", "done"]),
    (lambda: _launcher_trains("--arch", "seamless-m4t-large-v2",
                              "--reduced", "--host-devices", "2"),
     ["mesh: {'data': 1, 'model': 2} on 2 rank processes", "done"]),
    (_pipelined_adafactor_trains, ["dense/attn/wq split [0]",
                                   "dense/ln1 split [0]",
                                   "final_norm split []",
                                   "lm_head split []"]),
    (_group_norm_grad_trains, ["RMSNorm's over the whole row"]),
    (lambda: _launcher_trains("--arch", "yi-6b", "--reduced",
                              "--host-devices", "4", "--elastic",
                              "--fake-hosts", "2"),
     ["mesh: {'data': 2, 'model': 2} on 4 rank processes", "done"]),
    (lambda: _launcher_refuses("--arch", "yi-6b", "--reduced",
                               "--host-devices", "3"),
     ["128 columns of d_model", "vocabulary of 512 does not divide"]),
    (lambda: _launcher_refuses("--arch", "yi-6b", "--reduced"),
     ["--host-devices N", "A8d6"]),
    (_pipeline_refuses, ["model axis 2 on ranks",
                         "pipelined launcher runs with model axis 1"])],
    ids=["ssm", "hybrid", "encdec", "pipelined-adafactor",
         "group-rms-norm-grad", "elastic", "vocabulary", "no-mesh",
         "pipelined-model-axis"])
def test_what_a_model_axis_on_ranks_does_not_train_refuses(refuse, items):
    """Refused before any rank starts (the launcher exits with the
    message) or where it is called, naming its ROADMAP item or what does
    not divide. What refused until A8d5b, A8d6c and A8e runs and says so:
    the ssm, hybrid and encdec families train on ranks (the launcher's
    lines), ``group_rms_norm`` has its backward, ``--elastic`` trains on
    ranks and the pipelined ranks take Adafactor."""
    message = refuse()
    assert all(item in message for item in items), message


if __name__ == "__main__":
    _write_reference(sys.argv[1])
