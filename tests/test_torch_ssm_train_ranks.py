"""Training the ssm, hybrid and encdec families on a model axis of rank
processes, on the CPU (``make_train_step(cfg, mesh=)`` on a ("data",
"model") mesh laid on spawned processes; ``dist.tensor_parallel``'s
collectives with their backward).

The reduced mamba2-1.3b (2 Mamba-2 layers, one SSM group that every rank
of a model axis reads, its head tied to ``embed``), zamba2-1.2b (5 Mamba-2
layers, the shared block at two sites) and seamless-m4t-large-v2 (2
encoder and 2 decoder layers), f32 compute, each from ``repro``'s seed-0
parameters, on (1, 2), (2, 2) and (1, 4) meshes of ranks; mamba2 and
seamless also at a vocabulary of 510, which 4 does not divide (the
embedding and the head split on d_model, the tied head of mamba2 too).
Labels are masked unequally between the data ranks.

- two steps' losses (1e-6 relative) and |g| (1e-5) against the
  one-process port step, and against ``repro``'s jitted
  ``make_train_step`` with params and optimizer state placed by its specs
  on an Auto-axis ``jax.sharding.Mesh`` of the cell's shape over 4 forced
  host devices (an ``.npz`` from this file's script mode); with Mamba-2
  layers the first step's (below);
- each rank's gradient of every leaf against its box of the one-process
  gradient (1e-5 of the leaf's largest; a Mamba-2 leaf's box is its
  column pieces), and the first update of every weight that a gradient
  error within that bound cannot turn (AdamW's eps) to LR / 1000 of the
  one-process update. A random-weight Mamba-2 stack amplifies f32
  roundings (``chip_smoke.py``'s MODEL_TOL and TP_F32_NOISE notes): the
  reduced zamba2's one-process gradient moves 3.6e-6-4.9e-6 of a leaf's
  max when only the SSD's chunk length changes (4, 8 for the token
  recurrence at 16 positions), and its ranked gradient 1.0e-5-1.1e-5. So
  a cell with Mamba-2 layers measures that gap on one process and holds
  the gradients to NOISE times it where that exceeds 1e-5, and its second
  step, which starts from a first update whose tiny-gradient weights that
  noise turns, is not held;
- the ranks that hold the same box of a leaf, or the same column piece of
  a Mamba-2 leaf (the B and C columns of the group every rank reads),
  hold the same bits after the steps;
- the bytes a rank sends each peer in a step, by kind, equal their
  formula;
- an f64 ``gradcheck`` on 2 ranks of ``group_rms_norm`` between the
  d_model-sharded head's slice and the gather: the whole row's RMSNorm on
  every rank;
- planted faults fail the gradient check: the B/C columns' gradients not
  summed over their holders, the norm's backward sum left out, the head's
  slice with no gather in its backward;
- a (2, 2) zamba2 checkpoint (Mamba-2's leaves written as column boxes) is
  byte for byte the one-process ``save`` of the whole state and restores
  onto (1, 4) and (1, 2) bit for bit, the next step from it bit for bit
  the step from the same state sharded in memory;
- the launcher trains reduced zamba2-1.2b on 4 rank processes.

The rank functions live here (a spawned child imports this module, which
imports nothing of JAX at its top). Each world is spawned once for the
module: one of 4 ranks, one of 2.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.dist import ranks
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.ctx import use_mesh
from repro_torch.launch.mesh import Mesh
from repro_torch.models.convert import (params_from_reference,
                                        shard_params_from_reference)
from repro_torch.models.layers import take_box
from repro_torch.models.transformer import _hybrid_segments, abstract_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as train_step_mod
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import (loss_and_grads, make_train_step,
                                          ranked_grads, replica_columns,
                                          replica_leaves)
from repro_torch.train.tree import leaf_paths, tree_map, unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, SEQ, LR, STEP = 4, 16, 1e-3, 2        # STEP: the checkpoint's step
MAMBA, ZAMBA, SEAMLESS = "mamba2-1.3b", "zamba2-1.2b", "seamless-m4t-large-v2"
# cell -> (arch, data, model, vocabulary (0: the reduced config's))
CELLS = {"mamba2-tp2": (MAMBA, 1, 2, 0),
         "mamba2-dp2-tp2": (MAMBA, 2, 2, 0),
         "mamba2-tp4": (MAMBA, 1, 4, 0),
         "mamba2-v510-tp4": (MAMBA, 1, 4, 510),
         "zamba2-tp2": (ZAMBA, 1, 2, 0),
         "zamba2-dp2-tp2": (ZAMBA, 2, 2, 0),
         "zamba2-tp4": (ZAMBA, 1, 4, 0),
         "seamless-tp2": (SEAMLESS, 1, 2, 0),
         "seamless-dp2-tp2": (SEAMLESS, 2, 2, 0),
         "seamless-tp4": (SEAMLESS, 1, 4, 0),
         "seamless-v510-tp4": (SEAMLESS, 1, 4, 510)}
WORLDS = {4: [c for c, v in CELLS.items() if v[1] * v[2] == 4],
          2: [c for c, v in CELLS.items() if v[1] * v[2] == 2]}
CKPT_CELL = "zamba2-dp2-tp2"
# planted fault -> the cell it is planted in
PLANTS = {"bc-unsummed": "mamba2-tp4", "norm-unsummed": "zamba2-tp4",
          "slice-ungathered": "seamless-v510-tp4"}
TOL = 1e-5
# the ranks' gradient bound over one process's own sum-order gap
NOISE = 4.0


def _over(arch, base, vocab):
    """The reduced config of ``arch`` from ``base`` (either package's
    ``reduced(get_config(arch))``), f32 compute, zamba2 with 5 layers (its
    shared block at two sites), at ``vocab`` when nonzero."""
    cfg = dataclasses.replace(base, compute_dtype="float32")
    if arch == ZAMBA:
        cfg = dataclasses.replace(cfg, n_layers=5)
    return dataclasses.replace(cfg, vocab_size=vocab) if vocab else cfg


def _cfg(cell):
    arch, _, _, vocab = CELLS[cell]
    return _over(arch, reduced(get_config(arch)), vocab)


def _weights_key(cell):
    arch, _, _, vocab = CELLS[cell]
    return f"{arch}-{vocab}"


def _batch(cfg, step):
    """Batch ``step`` (numpy): ``SyntheticLM``'s tokens (and an encdec
    model's frame embeddings) and labels, 13 masked in rows 0-1 and 4 in
    rows 2-3."""
    b = SyntheticLM(cfg.vocab_size, SEQ, ROWS, seed=5,
                    embed_dim=cfg.d_model if cfg.embed_inputs else None,
                    encdec=cfg.family == "encdec").batch_at(step)
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


def _reference_tree(path, key):
    """``repro``'s seed-0 parameters of ``key`` (numpy) from the
    ``.npz``."""
    with np.load(path) as f:
        return _unflat({k.split("/", 1)[1]: f[k] for k in f.files
                        if k.startswith(f"params-{key}/")})


def _state_like(cfg):
    like = abstract_params(cfg)
    return {"params": like, "opt": adamw_init(like)}


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(leaf_paths(a), leaf_paths(b)))


# ------------------------------------------------------ rank functions

def _mesh(cell, device):
    _, data, model, _ = CELLS[cell]
    return Mesh((data, model), ("data", "model"), device,
                group=dist.group.WORLD)


def train_cell(rank, world, ref_path, cell, ckpt_dir, *, device):
    """One cell on this rank: its shard of ``repro``'s parameters, the
    ranked loss and gradients on batch 0, then two steps (batches 0 and 1):
    their metrics, the parameters after the first, the bytes sent in it and
    the state after the second; with ``ckpt_dir``, that state saved from
    the ranks as the launcher saves it."""
    cfg = _cfg(cell)
    mesh = _mesh(cell, device)
    params = shard_params_from_reference(
        cfg, _reference_tree(ref_path, _weights_key(cell)), mesh, device)
    b0, b1 = (_torch(_batch(cfg, s), device) for s in (0, 1))
    loss, grads = ranked_grads(cfg, mesh)(params, b0)
    step = make_train_step(cfg, lr=LR, mesh=mesh)
    mesh.transport.reset()
    params, opt, first = step(params, adamw_init(params), b0)
    sent = {k: list(v) for k, v in mesh.transport.bytes.items()}
    after = tree_map(torch.clone, params)
    params, opt, second = step(params, opt, b1)
    state = {"params": params, "opt": opt}
    like = _state_like(cfg)
    if ckpt_dir:
        ckpt.RankCheckpointer(
            ckpt_dir, like=like, rows=tp.shard_boxes(cfg, like, mesh),
            writes=(tp.owned(cfg, like, mesh) if mesh.coords["data"] == 0
                    else False)).save(STEP, state)
    return {"coords": mesh.coords, "loss": loss, "grads": grads,
            "metrics": [first, second], "after": after, "state": state,
            "boxes": tp.shard_boxes(cfg, like, mesh), "bytes": sent}


def _ungathered(ctx, g):
    """``_Slice``'s backward with its gather left out: the rank's slice of
    the gradient in place, zeros elsewhere."""
    n, c = g.shape[-1], ctx.mesh.coords["model"]
    return F.pad(g, (c * n, (ctx.mesh.shape["model"] - 1 - c) * n)), None


def planted_cell(rank, world, ref_path, plant, *, device):
    """The ranked gradients on batch 0 of ``PLANTS[plant]``'s cell with
    the fault planted in this process, then taken out again."""
    cell = PLANTS[plant]
    cfg = _cfg(cell)
    mesh = _mesh(cell, device)
    params = shard_params_from_reference(
        cfg, _reference_tree(ref_path, _weights_key(cell)), mesh, device)
    where, name, fault = {
        "bc-unsummed": (train_step_mod, "replica_columns",
                        lambda *a, **k: {}),
        "norm-unsummed": (tp._Both, "backward",
                          staticmethod(lambda ctx, g: (g, None))),
        "slice-ungathered": (tp._Slice, "backward",
                             staticmethod(_ungathered))}[plant]
    kept = where.__dict__[name]
    setattr(where, name, fault)
    try:
        _, grads = ranked_grads(cfg, mesh)(params,
                                           _torch(_batch(cfg, 0), device))
    finally:
        setattr(where, name, kept)
    return {"coords": mesh.coords, "grads": grads,
            "boxes": tp.shard_boxes(cfg, _state_like(cfg), mesh)}


def restore_cell(rank, world, ckpt_dir, data, model, *, device):
    """The (2, 2) checkpoint restored onto a (data, model) mesh: each
    rank's boxes (``restore(..., rows=)``, Mamba-2's as column boxes)
    against the same boxes of the whole state read on one process and
    sharded in memory, then one step (batch 2) from each: whether the
    restored shards, the states after the step and its metrics are bit for
    bit the same."""
    cfg = _cfg(CKPT_CELL)
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


class _F64:
    """A transport that sums and gathers any dtype (f64 here) over
    gloo."""

    @staticmethod
    def all_reduce(t, group, kind="reduce"):
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def all_gather(t, group):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous(), group=group)
        return parts


def gradcheck_cell(rank, world, *, device):
    """``gradcheck`` in f64 of G(x) = the rows of every rank's
    ``group_rms_norm`` of its d-slice of x, gathered: x [3, 8·world],
    which every rank holds, enters through the d_model-sharded head's
    slice (its backward gathers the slices' gradients) and the outputs
    through the gather (its backward takes the rank's slice), so G is the
    whole row's RMSNorm on every rank, and so is its Jacobian, only if
    the norm's backward sums the squares' gradient over the group."""
    mesh = Mesh((1, world), ("data", "model"), device,
                group=dist.group.WORLD)
    mesh.transport = _F64()
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(3, 8 * world, dtype=torch.float64, generator=gen)
    w = torch.randn(8 * world, dtype=torch.float64, generator=gen)
    w_r = w[8 * rank:8 * (rank + 1)]

    def norm(x):
        return tp._Gather.apply(tp.group_rms_norm(tp._Slice.apply(x, mesh),
                                                  w_r), mesh)

    with use_mesh(mesh):
        ok = torch.autograd.gradcheck(norm, (x.clone().requires_grad_(),))
        out = norm(x.clone().requires_grad_())
    want = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * w
    return {"ok": ok, "out": out.detach(), "want": want}


# ------------------------------------------------------------- worlds

def _write_reference(path):
    """``repro``'s seed-0 parameters of each (arch, vocabulary) and, per
    cell, its jitted ``make_train_step`` twice (batches 0 and 1) with
    params, optimizer state and batch placed by its specs on an Auto-axis
    mesh of the cell's shape over the 4 host devices, as its launcher
    places them: the metrics (this file's script mode)."""
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

    out, weights = {}, {}
    for cell, (arch, data, model, vocab) in CELLS.items():
        jcfg = _over(arch, jx_base.reduced(jx_get_config(arch)), vocab)
        key = _weights_key(cell)
        if key not in weights:
            weights[key] = jx_tfm.init_params(jcfg, jax.random.key(0))
            for name, a in leaf_paths(jax.tree.map(np.asarray,
                                                   weights[key])):
                out[f"params-{key}/{name}"] = a
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
                params = jax.device_put(weights[key],
                                        jx_sh.named_shardings(mesh, p_specs))
                opt = jax.device_put(jx_adamw_init(params),
                                     jx_sh.named_shardings(mesh, o_specs))
                step = jax.jit(jx_step(jcfg, lr=LR))
                for s in (0, 1):
                    b = {k: jax.device_put(jnp.asarray(v), NamedSharding(
                        mesh, JP(axes))) for k, v in _batch(
                            _cfg(cell), s).items()}
                    params, opt, m = step(params, opt, b)
                    out[f"{cell}/loss{s}"] = np.asarray(m["loss"])
                    out[f"{cell}/grad_norm{s}"] = np.asarray(m["grad_norm"])
        finally:
            jx_ctx.set_batch_axes(None)
            jx_ctx.set_seq_shard(False)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s outputs, from this file's script mode on 4 forced host
    devices; ``path`` is the ``.npz`` the ranks read the weights from."""
    path = tmp_path_factory.mktemp("jax_ssm_train_ranks") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as data:
        return {"path": str(path), **{k: data[k] for k in data.files}}


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """The 4-rank world (the (2, 2) and (1, 4) cells, the zamba2 (2, 2)
    checkpoint restored onto (1, 4), the planted faults) and the 2-rank
    world (the (1, 2) cells, the checkpoint restored onto (1, 2), the
    gradient check), each spawned once."""
    ck = str(tmp_path_factory.mktemp("ssm_train_ckpt"))
    path = reference["path"]
    four = ranks.spawn_ranks(ranks.run_jobs, 4, [
        (train_cell, (path, c, ck if c == CKPT_CELL else None), {})
        for c in WORLDS[4]] + [(restore_cell, (ck, 1, 4), {})] + [
        (planted_cell, (path, plant), {}) for plant in PLANTS],
        device="cpu", timeout=600)
    two = ranks.spawn_ranks(ranks.run_jobs, 2, [
        (train_cell, (path, c, None), {}) for c in WORLDS[2]] + [
        (restore_cell, (ck, 1, 2), {}), (gradcheck_cell, (), {})],
        device="cpu", timeout=600)
    out = {"ckpt": ck}
    for runs, cells, extra in ((four, WORLDS[4],
                                ["restore-tp4", *PLANTS]),
                               (two, WORLDS[2], ["restore-tp2",
                                                 "gradcheck"])):
        for i, name in enumerate(cells + extra):
            out[name] = [r[i] for r in runs]
    return out


def _gap(a, b) -> float:
    """The largest gap of two gradient trees, over each leaf's max|g| of
    ``a``."""
    return max(float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30)
               for (_, x), (_, y) in zip(leaf_paths(a), leaf_paths(b)))


@pytest.fixture(scope="module")
def one_process(reference):
    """Per cell, the one-process port on the same weights and batches: the
    loss and gradients on batch 0, the two steps' metrics and the
    parameters after the first; and the gradients' bound: 1e-5, or with
    Mamba-2 layers NOISE times the gap of one process's gradients at SSD
    chunks 8 and 4 from its own where that is larger."""
    out = {}
    for cell in CELLS:
        cfg = _cfg(cell)
        params = params_from_reference(
            _reference_tree(reference["path"], _weights_key(cell)),
            device="cpu")
        b0, b1 = (_torch(_batch(cfg, s)) for s in (0, 1))
        step = make_train_step(cfg, lr=LR)
        loss, grads = loss_and_grads(cfg, params, b0)
        gap = 0.0
        for chunk in ("8", "4") if cfg.ssm is not None else ():
            os.environ["REPRO_SSD_CHUNK"] = chunk
            try:
                gap = max(gap, _gap(grads, loss_and_grads(cfg, params,
                                                          b0)[1]))
            finally:
                del os.environ["REPRO_SSD_CHUNK"]
        params, opt, first = step(params, adamw_init(params), b0)
        after = tree_map(torch.clone, params)
        _, _, second = step(params, opt, b1)
        out[cell] = {"loss": loss, "grads": grads, "after": after,
                     "metrics": [first, second],
                     "tol": max(TOL, NOISE * gap),
                     "steps": 1 if cfg.ssm is not None else 2}
    return out


def _box_of(whole, run, name):
    """``run``'s box of the whole leaf ``name`` (of a parameter tree): its
    slices, or its column boxes joined."""
    return take_box(dict(leaf_paths(whole))[name],
                    run["boxes"][f"params/{name}"])


def _worst(grads, run) -> tuple:
    """The largest gap of ``run``'s gradient of a leaf from its box of
    ``grads``, over the box's max|g|, and the leaf's name."""
    worst = (0.0, "")
    for name, g in leaf_paths(run["grads"]):
        w = _box_of(grads, run, name)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, (err, name))
    return worst


# ------------------------------------------------------------ the step

@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_losses_and_norms_match_one_process_and_reference(
        worlds, one_process, reference, cell):
    want = one_process[cell]
    for run in worlds[cell]:
        assert abs(float(run["loss"]) - float(want["loss"])) \
            <= 1e-6 * float(want["loss"]), run["coords"]
        for s, (got, one) in enumerate(zip(run["metrics"],
                                           want["metrics"][:want["steps"]])):
            for key, tol in (("loss", 1e-6), ("grad_norm", 1e-5)):
                assert abs(float(got[key]) - float(one[key])) \
                    <= tol * float(one[key]), (s, key, run["coords"])
                ref = float(reference[f"{cell}/{key}{s}"])
                assert abs(float(got[key]) - ref) <= 1e-5 * ref, \
                    (s, key, run["coords"], float(got[key]), ref)


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_leaf_gradients_are_boxes_of_one_process(worlds, one_process,
                                                        cell):
    """Every leaf: Mamba-2's column pieces (the B and C columns summed over
    their holders), the replicated norms, the d_model-split embedding and
    head."""
    want = one_process[cell]
    for run in worlds[cell]:
        err, name = _worst(want["grads"], run)
        assert err <= want["tol"], (cell, run["coords"], name, err)


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_first_update_matches_one_process(worlds, one_process, cell):
    """Each weight's first update to LR / 1000 of the one-process one
    wherever a gradient error within the gradients' bound δ (of the leaf's
    max|g|) cannot turn it by more: AdamW's first step moves a weight by
    lr·g/(|g| + eps), which an error δ turns by up to lr·eps·δ/(|g| +
    eps)², so the weights with (|g| + eps)² >= 1e3·eps·δ and |g| > 1e-5
    max|g| (``chip_smoke.py``'s ``tp_update_gate``)."""
    want = one_process[cell]
    eps = 1e-8                        # train/optimizer.py's adamw_update
    for run in worlds[cell]:
        assert int(run["state"]["opt"].step) == 2
        for name, p in leaf_paths(run["after"]):
            g = _box_of(want["grads"], run, name).abs()
            held = (g > 1e-5 * g.max()) & (
                (g + eps) ** 2 >= 1e3 * eps * want["tol"] * g.max())
            w = _box_of(want["after"], run, name)
            assert held.any(), name
            err = float(((p - w).abs() * held).max())
            assert err <= LR * 1e-3, (cell, name, err)


def _pieces(box):
    """A box as its column pieces: (the piece's box of the whole leaf, the
    columns [lo, hi) where it lies in the rank's joined leaf); a box that
    is not a list one piece, all of the rank's leaf (hi None)."""
    if not isinstance(box, list):
        return [(box, 0, None)]
    out, at = [], 0
    for b in box:
        width = b[-1].stop - b[-1].start
        out.append((b, at, at + width))
        at += width
    return out


def _cols(t, lo, hi):
    """Columns [lo, hi) of ``t`` (all of it where ``hi`` is None)."""
    return t if hi is None else t[..., lo:hi]


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranks_holding_one_box_hold_the_same_bits(worlds, cell):
    """After the two steps the ranks that hold the same box of a leaf, or
    the same column piece of a Mamba-2 leaf, hold the same parameters and
    moments, bit for bit: the B and C columns every rank reads, the
    replicated norms, every leaf across the data axis."""
    runs = worlds[cell]
    pieces = 0
    for i, a in enumerate(runs):
        for b in runs[i + 1:]:
            theirs = dict(leaf_paths(b["state"]))
            for name, t in leaf_paths(a["state"]):
                for box, lo, hi in _pieces(a["boxes"][name]):
                    for other, lo2, hi2 in _pieces(b["boxes"][name]):
                        if box == other:
                            assert torch.equal(
                                _cols(t, lo, hi),
                                _cols(theirs[name], lo2, hi2)), (
                                name, a["coords"], b["coords"])
                            pieces += 1
    assert pieces


@pytest.mark.parametrize("arch,model,shared", [
    (MAMBA, 4, 2), (MAMBA, 2, 2), (ZAMBA, 4, 2), (SEAMLESS, 4, 0)])
def test_replica_columns_are_the_b_and_c_of_a_shared_group(arch, model,
                                                           shared):
    """With one SSM group every rank of the model axis reads it: the B and
    C columns of ``w_in``, ``conv_w`` and ``conv_b`` are pieces held by the
    whole line; no whole leaf of the region is; seamless has none."""
    cfg = _over(arch, reduced(get_config(arch)), 0)
    n = cfg.ssm.d_state if cfg.ssm else 0
    for c in range(model):
        mesh = types.SimpleNamespace(shape={"data": 1, "model": model},
                                     coords={"data": 0, "model": c})
        assert replica_leaves(cfg, mesh) == {}
        got = replica_columns(cfg, mesh)
        assert sorted(got) == ([] if not shared else sorted(
            f"ssm/mamba/{leaf}" for leaf in ("w_in", "conv_w", "conv_b")))
        for pieces in got.values():
            assert len(pieces) == shared
            for lo, hi, holders in pieces:
                assert hi - lo == n and holders == tuple(range(model))


# --------------------------------------------------------------- bytes

def _reduce_bytes(cfg, model, t, frames):
    """The f32 bytes all-reduced with each model peer in one step of ``t``
    tokens (``frames`` encoder frames), remat full: in units of [t,
    d_model] per Mamba-2 layer its ``w_out`` sum and f (and its norm's [t,
    1] sum three times: the forward, the recomputed block, the backward's
    sum), per shared site and attention layer 5, per encdec decoder layer
    8 and its cross keys' f at [frames, d_model], per encoder layer 5 at
    [frames, d_model]; a vocab-sharded embedding's sum and head's f, or a
    d_model-split head's f32 partials [t, V]."""
    d = cfg.d_model
    if cfg.family == "encdec":
        units = 8 * cfg.n_layers * t + (5 * cfg.encoder_layers
                                        + cfg.n_layers) * frames
        squares = 0
    else:
        sites = (len(_hybrid_segments(cfg)) - 1
                 if cfg.family == "hybrid" else 0)
        units = (2 * cfg.n_layers + 5 * sites) * t
        squares = 3 * cfg.n_layers * t
    if tp.vocab_sharded(cfg, model):
        return 4 * d * (units + 2 * t) + 4 * squares
    return 4 * d * units + 4 * squares + 4 * t * cfg.vocab_size


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_step_bytes_per_peer(worlds, cell):
    """One step, to each other rank of the model line: the all-reduces of
    ``_reduce_bytes`` (``reduce``); f32 logits [rows, SEQ, V / model], or
    where the head splits d_model the embedding's and the head input's
    gradient's d-slices [rows, SEQ, d_model / model] (``gather``); to the
    other holders of a B/C column piece its gradient (``replica``). To the
    data peer every gradient's f32 bytes (``grad``). Scalars: the loss to
    the data peer, |g|² to the model peers."""
    _, data, model, _ = CELLS[cell]
    cfg = _cfg(cell)
    runs = worlds[cell]
    rank_at = {tuple(r["coords"].values()): i for i, r in enumerate(runs)}
    rows = ROWS // data
    t = rows * SEQ
    frames = t if cfg.family == "encdec" else 0
    for run in runs:
        d, c = run["coords"]["data"], run["coords"]["model"]
        model_peers = [rank_at[(d, m)] for m in range(model) if m != c]
        data_peers = [rank_at[(e, c)] for e in range(data) if e != d]
        want = {k: [0] * len(runs) for k in ("p2p", "reduce", "gather",
                                             "scalar", "grad", "replica")}
        grads = dict(leaf_paths(run["grads"]))
        for p in model_peers:
            want["reduce"][p] = _reduce_bytes(cfg, model, t, frames)
            want["gather"][p] = 4 * t * (
                cfg.vocab_size // model if tp.vocab_sharded(cfg, model)
                else 2 * cfg.d_model // model)
            want["scalar"][p] = 4
        for p in data_peers:
            want["grad"][p] = sum(g.nbytes for g in grads.values())
            want["scalar"][p] = 4
        mesh = types.SimpleNamespace(shape={"data": data, "model": model},
                                     coords=run["coords"])
        for name, pieces in replica_columns(cfg, mesh).items():
            g = grads[name]
            for lo, hi, holders in pieces:
                for m in holders:
                    if m != c:
                        want["replica"][rank_at[(d, m)]] += \
                            g.numel() // g.shape[-1] * (hi - lo) * 4
        if not any(want["replica"]):
            del want["replica"]
        if data == 1:
            del want["grad"]
        assert run["bytes"] == want, (cell, run["coords"])


# --------------------------------------------------- gradient checks

def test_group_norm_between_the_slice_and_the_gather_passes_gradcheck(
        worlds):
    for run in worlds["gradcheck"]:
        assert run["ok"]
        torch.testing.assert_close(run["out"], run["want"], rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("plant", list(PLANTS))
def test_planted_faults_fail_the_gradient_check(worlds, one_process, plant):
    """Each fault moves some rank's gradient of some leaf by far more than
    the check's bound, in the cell that passes it unplanted."""
    cell = PLANTS[plant]
    want = one_process[cell]
    assert all(_worst(want["grads"], run)[0] <= want["tol"]
               for run in worlds[cell])
    worst = max(_worst(want["grads"], run) for run in worlds[plant])
    assert worst[0] > 100 * want["tol"], (plant, worst)


# -------------------------------------------------------- checkpoints

def _assemble(cfg, runs):
    """The whole state of the data-rank-0 ranks' boxes (column pieces
    placed one by one)."""
    like = _state_like(cfg)
    whole = {name: torch.zeros(t.shape, dtype=t.dtype)
             for name, t in leaf_paths(like)}
    for run in runs:
        if run["coords"]["data"] == 0:
            for name, t in leaf_paths(run["state"]):
                for box, lo, hi in _pieces(run["boxes"][name]):
                    whole[name][box] = _cols(t, lo, hi)
    return unflatten(like, [whole[name] for name, _ in leaf_paths(like)])


def test_ranked_checkpoint_is_the_one_process_save(worlds):
    state = _assemble(_cfg(CKPT_CELL), worlds[CKPT_CELL])
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

def _train(*args):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", ZAMBA, "--reduced", "--device", "cpu",
                           "--host-devices", "4", "--steps", "3",
                           "--global-batch", "4", "--seq", "32", *args],
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO, env=env)


def test_train_launcher_trains_zamba2_on_a_model_axis_of_ranks(tmp_path):
    """The reference's lines: the mesh on 4 rank processes, a step line at
    steps 0 and 2 and ``done``; the losses those of the logical (1, 4)
    run's lines within bf16's rounding of the products (the launcher's
    compute dtype; each rank rounds its own columns)."""
    lines = {}
    for how in ("ranks", "logical"):
        proc = _train(*(["--ranks"] if how == "ranks" else []),
                      "--ckpt-dir", str(tmp_path / how))
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines[how] = proc.stdout.splitlines()
    out = lines["ranks"]
    assert out[0].startswith("mesh: {'data': 1, 'model': 4} on 4 rank "
                             "processes (cpu), arch=zamba2-1.2b ("), out[0]
    steps = [[ln.split() for ln in lines[how] if ln.startswith("step")]
             for how in ("ranks", "logical")]
    assert [s[1] for s in steps[0]] == [s[1] for s in steps[1]] == ["0", "2"]
    for got, want in zip(*steps):
        assert got[2] == "loss" and got[4] == "|g|" and got[7] == "tok/s"
        assert abs(float(got[3]) - float(want[3])) <= 1e-2 * float(want[3])
    assert out[-1] == "done"
    assert ckpt.latest_step(str(tmp_path / "ranks")) == 2


if __name__ == "__main__":
    _write_reference(sys.argv[1])
