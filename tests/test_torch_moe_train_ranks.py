"""Training the moe family (MLA included) on a model axis of rank
processes, on the CPU, with the configs' Adafactor: the ("data",
"model") mesh laid on spawned processes joined into a gloo group
(``make_train_step(cfg, mesh=)``, ``dist.tensor_parallel``'s collectives
with their backward, ``optimizer.ranked_adafactor_update``).

The reduced grok-1-314b (GQA, 4 query heads over 2 KV heads, 8 experts
top-2, softmax router, GELU, 2 MoE layers) and deepseek-v3-671b (MLA over
4 heads, one dense layer then one MoE layer of 8 routed experts top-8 and
one shared, sigmoid router, SwiGLU), f32 compute, with ``repro``'s seed-0
parameters (drawn in the configs' bf16, a nonzero router bias) held in
f32 by both packages, so that a gradient is not rounded to bf16 at its
leaf and the tolerances below hold. Cells: grok on (1, 2), (1, 4)
(``kv_head_pad`` 2) and (2, 2), grok with 6 experts on (1, 4) (the
hidden-dim fallback: every rank holds every expert's quarter of the
hidden dim), deepseek on (1, 4) and (2, 2) at capacity factor 0.5
(``REPRO_MOE_CF``, read by both packages; its top-8 of 8 keeps every slot
at the config's); each with Adafactor, grok on (1, 2) with AdamW too.

- two steps' losses (1e-6 relative) and |g| (1e-5) against the
  one-process port step under the cell's logical mesh (its MoE dispatch
  rows: a data rank routes its own rows), and against ``repro``'s jitted
  ``make_train_step`` with params, optimizer state and batch placed by its
  specs on an Auto-axis ``jax.sharding.Mesh`` of the cell's shape over 4
  forced host devices (an ``.npz`` from this file's script mode, run
  beside the rank worlds; 1e-5);
- each rank's gradient of every leaf, the router and MLA's ``wq_a``,
  ``wkv_a``, ``q_ln`` and ``kv_ln`` included, against its box of the
  one-process gradient (1e-5 of the leaf's largest); ``router_bias``'s
  zero on every rank, as on one process;
- the first update against one process's and ``repro``'s; each rank's
  Adafactor ``vr``/``vc`` after two steps against its boxes of one
  process's (1e-5 of the leaf's largest);
- the ranks that hold the same box of a leaf hold the same bits;
- the bytes a rank sends each peer in a step, by kind, equal their
  formula (the router's sums: ``replica``; Adafactor's statistics:
  ``adafactor``);
- planted faults in MLA's f (its sum missing, or taken twice) fail the
  gradient check; a ``gradcheck`` in f64 of ``sum_partials`` on 2 ranks;
- the (2, 2) deepseek world's ``RankCheckpointer`` directory of its
  Adafactor state is byte for byte the one-process ``save``; restored onto
  (1, 4) each rank reads its own boxes bit for bit, and the next step from
  them is bit for bit the step from the same state sharded in memory;
- the launcher trains the reduced grok on 4 rank processes with
  Adafactor.

The rank functions live here (a spawned child imports this module, which
imports nothing of JAX at its top). Each world is spawned once for the
module: one of 4 ranks, one of 2.
"""

import contextlib
import dataclasses
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
from repro_torch.dist.ctx import launch_mesh, use_mesh
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import (params_from_reference,
                                        shard_params_from_reference)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import (adafactor_shards, loss_and_grads,
                                          make_train_step, ranked_grads,
                                          replica_leaves)
from repro_torch.train.tree import leaf_paths, tree_map, unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, SEQ, LR, STEP = 4, 16, 1e-3, 2        # STEP: the checkpoint's step
# cell -> (arch, data, model, routed experts, optimizer, REPRO_MOE_CF)
CELLS = {"grok-tp2": ("grok-1-314b", 1, 2, 8, "adafactor", ""),
         "grok-tp2-adamw": ("grok-1-314b", 1, 2, 8, "adamw", ""),
         "grok-tp4": ("grok-1-314b", 1, 4, 8, "adafactor", ""),
         "grok-dp2-tp2": ("grok-1-314b", 2, 2, 8, "adafactor", ""),
         "grok6-tp4": ("grok-1-314b", 1, 4, 6, "adafactor", ""),
         "deepseek-tp4": ("deepseek-v3-671b", 1, 4, 8, "adafactor", "0.5"),
         "deepseek-dp2-tp2": ("deepseek-v3-671b", 2, 2, 8, "adafactor",
                              "0.5")}
WORLDS = {4: ["grok-tp4", "grok-dp2-tp2", "grok6-tp4", "deepseek-tp4",
              "deepseek-dp2-tp2"],
          2: ["grok-tp2", "grok-tp2-adamw"]}
CKPT_CELL = "deepseek-dp2-tp2"
MLA_LEAVES = ("wq_a", "wkv_a", "q_ln", "kv_ln")
FAULTS = ("missing", "doubled")
EPS = 1e-8                     # train/optimizer.py's adamw_update


def _cfg(cell):
    arch, _, _, experts, opt, _ = CELLS[cell]
    cfg = reduced(get_config(arch), compute_dtype="float32",
                  param_dtype="float32", optimizer=opt)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=experts))


def _weights_key(cell):
    """Cells share ``repro``'s weights by (arch, experts)."""
    arch, _, _, experts, _, _ = CELLS[cell]
    return f"{arch}-{experts}"


@contextlib.contextmanager
def _capacity(cf: str):
    """``REPRO_MOE_CF`` set to ``cf`` (unset when empty) for the block."""
    old = os.environ.pop("REPRO_MOE_CF", None)
    if cf:
        os.environ["REPRO_MOE_CF"] = cf
    try:
        yield
    finally:
        os.environ.pop("REPRO_MOE_CF", None)
        if old is not None:
            os.environ["REPRO_MOE_CF"] = old


def _batch(cfg, step):
    """Batch ``step`` (numpy): ``SyntheticLM``'s tokens and labels, 13
    masked in rows 0-1 and 4 in rows 2-3."""
    b = SyntheticLM(cfg.vocab_size, SEQ, ROWS, seed=5).batch_at(step)
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
    """``repro``'s seed-0 parameters of ``key`` (numpy, f32)."""
    with np.load(path) as f:
        return _unflat({k.split("/", 1)[1]: f[k] for k in f.files
                        if k.startswith(f"params-{key}/")})


def _state_like(cfg):
    like = tfm.abstract_params(cfg)
    return {"params": like, "opt": make_optimizer(cfg.optimizer)[0](like)}


def _logical(cell):
    _, data, model, _, _, _ = CELLS[cell]
    return Mesh((data, model), ("data", "model"), "cpu")


# ------------------------------------------------------ rank functions

def train_cell(rank, world, ref_path, cell, ckpt_dir, *, device):
    """One cell on this rank: its shard of ``repro``'s parameters, the
    ranked loss and gradients on batch 0, then two steps (batches 0 and 1):
    their metrics, the parameters after the first, the bytes sent in it and
    the state after the second; with ``ckpt_dir``, that state saved from
    the ranks as the launcher saves it."""
    _, data, model, _, _, cf = CELLS[cell]
    cfg = _cfg(cell)
    mesh = Mesh((data, model), ("data", "model"), device,
                group=dist.group.WORLD)
    params = shard_params_from_reference(
        cfg, _reference_tree(ref_path, _weights_key(cell)), mesh, device)
    b0, b1 = (_torch(_batch(cfg, s), device) for s in (0, 1))
    with _capacity(cf):
        loss, grads = ranked_grads(cfg, mesh)(params, b0)
        step = make_train_step(cfg, lr=LR, mesh=mesh)
        mesh.transport.reset()
        params, opt, first = step(params, make_optimizer(cfg.optimizer)[0](
            params), b0)
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


def restore_cell(rank, world, ckpt_dir, data, model, *, device):
    """The (2, 2) checkpoint restored onto a (data, model) mesh: each
    rank's boxes (``restore(..., rows=)``) against the same boxes of the
    whole state read on one process and sharded in memory, then one step
    (batch 2) from each: whether the restored shards, the states after the
    step and its metrics are bit for bit the same."""
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
    batch = _torch(_batch(cfg, 2), device)
    with _capacity(CELLS[CKPT_CELL][5]):
        step = make_train_step(cfg, lr=LR, mesh=mesh)
        p1, o1, m1 = step(got["params"], got["opt"], batch)
        p2, o2, m2 = step(want["params"], want["opt"], batch)
    return {"coords": mesh.coords, "restored": same,
            "next": _same((p1, o1), (p2, o2)) and all(
                torch.equal(m1[k], m2[k]) for k in m1)}


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(leaf_paths(a), leaf_paths(b)))


def planted_cell(rank, world, ref_path, fault, *, device):
    """deepseek on (1, 4) with a fault planted in MLA's f (the latents'
    ``copy_all_to_model``): ``missing``, the identity (each rank keeps its
    own heads' part of the latents' gradient), or ``doubled``, f taken
    twice (the sum summed again: the model axis times the gradient). The
    ranked gradients on batch 0."""
    cell = "deepseek-tp4"
    _, data, model, _, _, cf = CELLS[cell]
    cfg = _cfg(cell)
    mesh = Mesh((data, model), ("data", "model"), device,
                group=dist.group.WORLD)
    params = shard_params_from_reference(
        cfg, _reference_tree(ref_path, _weights_key(cell)), mesh, device)
    real = tfm.copy_all_to_model
    tfm.copy_all_to_model = {
        "missing": lambda *xs: xs,
        "doubled": lambda *xs: real(*real(*xs))}[fault]
    try:
        with _capacity(cf):
            _, grads = ranked_grads(cfg, mesh)(
                params, _torch(_batch(cfg, 0), device))
    finally:
        tfm.copy_all_to_model = real
    return {"coords": mesh.coords, "grads": grads,
            "boxes": tp.shard_boxes(cfg, _state_like(cfg), mesh)}


class _F64:
    """A transport whose all-reduce sums any dtype (f64 here) over gloo."""

    @staticmethod
    def all_reduce(t, group, kind="reduce"):
        dist.all_reduce(t, group=group)
        return t


def gradcheck_cell(rank, world, *, device):
    """``gradcheck`` in f64 of ``sum_partials`` as the MoE uses it: two
    partials of every rank, P_r = tanh(f(x) @ A_r) @ B_r and Q_r = tanh(f(x)
    @ C_r) @ D_r (A_r, C_r this rank's columns, B_r, D_r its rows), summed
    in one stacked all-reduce; its backward is the identity on each, f's
    sums x's gradient over the group, so the outputs are tanh(x @ A) @ B
    and tanh(x @ C) @ D on every rank, and so is their Jacobian."""
    mesh = Mesh((1, world), ("data", "model"), device,
                group=dist.group.WORLD)
    mesh.transport = _F64()
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(3, 5, dtype=torch.float64, generator=gen)
    w = [torch.randn(*shape, dtype=torch.float64, generator=gen)
         for shape in ((5, 4 * world), (4 * world, 6), (5, 2 * world),
                       (2 * world, 6))]
    a, b, c, d = w
    cols = slice(4 * rank, 4 * (rank + 1))
    half = slice(2 * rank, 2 * (rank + 1))

    def moe(x):
        x = tp.copy_to_model(x)
        return tuple(tp.sum_partials(torch.tanh(x @ a[:, cols]) @ b[cols],
                                     torch.tanh(x @ c[:, half]) @ d[half]))

    with use_mesh(mesh):
        ok = torch.autograd.gradcheck(moe, (x.clone().requires_grad_(),))
        out = moe(x.clone().requires_grad_())
    return {"ok": ok, "out": [t.detach() for t in out],
            "want": [torch.tanh(x @ a) @ b, torch.tanh(x @ c) @ d]}


# ------------------------------------------------------------- worlds

def _write_params(path):
    """``repro``'s seed-0 parameters of each (arch, experts), drawn in the
    configs' bf16 with a nonzero router bias, stored as f32 (exact)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jx_base
    from repro.configs.registry import get_config as jx_get_config
    from repro.models import transformer as jx_tfm

    out = {}
    for key in sorted({_weights_key(cell) for cell in CELLS}):
        arch, experts = key.rsplit("-", 1)
        experts = int(experts)
        jcfg = jx_base.reduced(jx_get_config(arch))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_experts=experts))
        jp = jx_tfm.init_params(jcfg, jax.random.key(0))
        bias = jp["moe"]["moe"]["router_bias"]
        jp["moe"]["moe"]["router_bias"] = jnp.asarray(
            np.random.default_rng(7).standard_normal(bias.shape) * 0.1,
            bias.dtype)
        for name, a in leaf_paths(jax.tree.map(np.asarray, jp)):
            out[f"params-{key}/{name}"] = a.astype(np.float32)
    np.savez(path, **out)


def _write_steps(params_path, path):
    """Per cell, ``repro``'s jitted ``make_train_step`` twice (batches 0
    and 1) with params, optimizer state and batch placed by its specs on
    an Auto-axis mesh of the cell's shape over the 4 host devices, as its
    launcher places them: the metrics and the parameters after the first
    step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.configs import base as jx_base
    from repro.configs.registry import get_config as jx_get_config
    from repro.dist import ctx as jx_ctx
    from repro.dist import sharding as jx_sh
    from repro.models import transformer as jx_tfm
    from repro.train.optimizer import make_optimizer as jx_optimizer
    from repro.train.optimizer import opt_state_specs
    from repro.train.train_step import make_train_step as jx_step

    out = {}
    for cell, (arch, data, model, experts, opt, cf) in CELLS.items():
        jcfg = jx_base.reduced(jx_get_config(arch), compute_dtype="float32",
                               param_dtype="float32", optimizer=opt)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_experts=experts))
        init, _ = jx_optimizer(opt)
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:data * model]).reshape(data, model),
            ("data", "model"))
        axes = jx_sh.batch_axis(mesh, ROWS)
        jx_ctx.set_batch_axes(axes)
        jx_ctx.set_seq_shard(SEQ % model == 0)
        try:
            with _capacity(cf), jx_ctx.use_mesh(mesh):
                p_abs = jx_tfm.abstract_params(jcfg)
                p_specs = jx_sh.sanitize_specs(
                    jx_sh.param_specs(jcfg, model_axis=model), p_abs, mesh)
                o_abs = jax.eval_shape(init, p_abs)
                o_specs = jx_sh.sanitize_specs(
                    opt_state_specs(p_specs, opt, p_abs), o_abs, mesh)
                jp = jax.tree.map(jnp.asarray, _reference_tree(
                    params_path, _weights_key(cell)))
                params = jax.device_put(jp, jx_sh.named_shardings(mesh,
                                                                  p_specs))
                state = jax.device_put(init(params),
                                       jx_sh.named_shardings(mesh, o_specs))
                step = jax.jit(jx_step(jcfg, lr=LR))
                for s in (0, 1):
                    b = {k: jax.device_put(jnp.asarray(v), NamedSharding(
                        mesh, JP(axes))) for k, v in _batch(
                            _cfg(cell), s).items()}
                    params, state, m = step(params, state, b)
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


def _script(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    env.pop("REPRO_MOE_CF", None)
    return [sys.executable, os.path.abspath(__file__), *map(str, args)], env


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s parameters (``path``, the ``.npz`` the ranks read), and
    its steps started in this file's script mode on 4 forced host devices,
    to run beside the rank worlds (``steps`` waits for them)."""
    d = tmp_path_factory.mktemp("jax_moe_train_ranks")
    cmd, env = _script("params", d / "params.npz")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    cmd, env = _script("steps", d / "params.npz", d / "steps.npz")
    log = open(d / "steps.log", "w+")
    steps = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                             stderr=subprocess.STDOUT)
    yield {"path": str(d / "params.npz"), "steps": steps, "log": log,
           "out": str(d / "steps.npz")}
    if steps.poll() is None:
        steps.kill()
        steps.wait()
    log.close()


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """The 4-rank world (grok on (1, 4), (2, 2) and with 6 experts,
    deepseek on (1, 4) and (2, 2) with its checkpoint, restored onto (1,
    4), the planted faults) and the 2-rank world (grok on (1, 2) with each
    optimizer, the gradient check)."""
    ck = str(tmp_path_factory.mktemp("moe_train_ckpt"))
    path = reference["path"]
    four = ranks.spawn_ranks(ranks.run_jobs, 4, [
        *[(train_cell, (path, cell, ck if cell == CKPT_CELL else None), {})
          for cell in WORLDS[4]],
        (restore_cell, (ck, 1, 4), {}),
        *[(planted_cell, (path, fault), {}) for fault in FAULTS]],
        device="cpu", timeout=300)
    two = ranks.spawn_ranks(ranks.run_jobs, 2, [
        *[(train_cell, (path, cell, None), {}) for cell in WORLDS[2]],
        (gradcheck_cell, (), {})], device="cpu", timeout=300)
    out = {"ckpt": ck}
    for runs, cells in ((four, WORLDS[4]), (two, WORLDS[2])):
        out.update({cell: [r[i] for r in runs]
                    for i, cell in enumerate(cells)})
    n = len(WORLDS[4])
    out["restore-tp4"] = [r[n] for r in four]
    out.update({f"planted-{fault}": [r[n + 1 + i] for r in four]
                for i, fault in enumerate(FAULTS)})
    out["gradcheck"] = [r[len(WORLDS[2])] for r in two]
    return out


@pytest.fixture(scope="module")
def steps(reference, worlds):
    """``repro``'s step outputs (waited for after the worlds ran)."""
    proc = reference["steps"]
    rc = proc.wait(timeout=600)
    reference["log"].seek(0)
    assert rc == 0, reference["log"].read()[-5000:]
    with np.load(reference["out"]) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def one_process(reference):
    """Per cell, the one-process port on the same weights and batches under
    the cell's logical mesh (its MoE dispatch rows): the loss and
    gradients on batch 0, the two steps' metrics, the parameters after the
    first and the state after the second."""
    out = {}
    for cell, (_, _, _, _, _, cf) in CELLS.items():
        cfg = _cfg(cell)
        params = params_from_reference(
            _reference_tree(reference["path"], _weights_key(cell)),
            device="cpu")
        b0, b1 = (_torch(_batch(cfg, s)) for s in (0, 1))
        step = make_train_step(cfg, lr=LR)
        with _capacity(cf), launch_mesh(_logical(cell), global_batch=ROWS):
            loss, grads = loss_and_grads(cfg, params, b0)
            params, opt, first = step(params, make_optimizer(
                cfg.optimizer)[0](params), b0)
            after = tree_map(torch.clone, params)
            params, opt, second = step(params, opt, b1)
        out[cell] = {"loss": loss, "grads": grads, "after": after,
                     "metrics": [first, second],
                     "state": {"params": params, "opt": opt}}
    return out


def _box_of(whole, run, name, prefix="params/"):
    """``run``'s box of the whole leaf ``name`` (of a parameter tree, or of
    the state tree with ``prefix`` "")."""
    leaf = dict(leaf_paths(whole))[name]
    return leaf[run["boxes"][prefix + name]] if leaf.ndim else leaf


def _grad_errors(grads, run) -> dict:
    """``{leaf: max|ranked - one-process box| / max|box|}`` of a rank's
    gradients."""
    out = {}
    for name, g in leaf_paths(run["grads"]):
        w = _box_of(grads, run, name)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        out[name] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
    return out


# ------------------------------------------------------------ the step

@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_moe_losses_and_norms_match_one_process_and_reference(
        worlds, one_process, steps, cell):
    want = one_process[cell]
    for run in worlds[cell]:
        assert abs(float(run["loss"]) - float(want["loss"])) \
            <= 1e-6 * float(want["loss"]), run["coords"]
        for s, (got, one) in enumerate(zip(run["metrics"], want["metrics"])):
            for key, tol in (("loss", 1e-6), ("grad_norm", 1e-5)):
                assert abs(float(got[key]) - float(one[key])) \
                    <= tol * float(one[key]), (s, key, run["coords"])
                ref = float(steps[f"{cell}/{key}{s}"])
                assert abs(float(got[key]) - ref) <= 1e-5 * ref, \
                    (s, key, run["coords"], float(got[key]), ref)


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_moe_leaf_gradients_are_boxes_of_one_process(
        worlds, one_process, cell):
    """Every leaf: the router (summed over the ranks' slots), MLA's whole
    down-projections and norms (their latents' f), the expert banks and
    the shared experts; ``router_bias`` only selects: zero everywhere."""
    grads = one_process[cell]["grads"]
    for run in worlds[cell]:
        for name, err in _grad_errors(grads, run).items():
            assert err <= 1e-5, (cell, run["coords"], name, err)
        bias = dict(leaf_paths(run["grads"]))["moe/moe/router_bias"]
        assert not bias.any() and not dict(leaf_paths(grads))[
            "moe/moe/router_bias"].any()


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_mla_f_fails_the_gradient_check(worlds, one_process,
                                                   fault):
    """With the latents' sum missing, each rank's MLA leaves get its own
    heads' part; taken twice, 4 times the gradient: either is far past the
    check's 1e-5."""
    grads = one_process["deepseek-tp4"]["grads"]
    for run in worlds[f"planted-{fault}"]:
        errs = _grad_errors(grads, run)
        worst = max(errs[f"{seg}/attn/{leaf}"] for seg in ("dense", "moe")
                    for leaf in MLA_LEAVES)
        assert worst > 1e-2, (fault, run["coords"], worst)


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_moe_first_update_matches_one_process_and_reference(
        worlds, one_process, steps, cell):
    """Each weight's first update to LR / 1000 of the one-process one and
    of ``repro``'s. Adafactor's is a smooth function of the gradient, held
    everywhere. AdamW's moves a weight by lr·g/(|g| + eps), which a
    gradient error δ within the gradient check's (1e-5 of the leaf's
    max|g|) turns by up to lr·eps·δ/(|g| + eps)²: held where that stays
    under LR / 1000 and |g| exceeds 1e-5 of max|g| (``chip_smoke.py``'s
    ``tp_update_gate``; experts that few tokens reach have such weights)."""
    want = one_process[cell]
    adamw = CELLS[cell][4] == "adamw"
    theirs = _unflat({k.split("/", 2)[2]: v for k, v in steps.items()
                      if k.startswith(f"{cell}/after/")})
    for run in worlds[cell]:
        assert int(run["state"]["opt"].step) == 2
        for name, p in leaf_paths(run["after"]):
            g = _box_of(want["grads"], run, name).abs()
            moved = ((g > 1e-5 * g.max()) & ((g + EPS) ** 2 >= 1e3 * EPS
                                              * 1e-5 * g.max())
                     if adamw else torch.ones_like(g, dtype=torch.bool))
            for w in (_box_of(want["after"], run, name),
                      torch.from_numpy(_box_of(theirs, run, name))):
                err = float(((p - w).abs() * moved).max())
                assert err <= LR * 1e-3, (cell, name, err)


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if CELLS[c][4] == "adafactor"])
def test_ranked_adafactor_factors_are_boxes_of_one_process(
        worlds, one_process, cell):
    """After two steps each rank's ``vr`` and ``vc`` (the row factor of a
    column-split leaf whole, the column factor of a row-split one whole)
    within 1e-5 of the leaf's largest of its boxes of one process's."""
    whole = one_process[cell]["state"]
    n = 0
    for run in worlds[cell]:
        for name, t in leaf_paths(run["state"]["opt"]):
            if name == "step":
                continue
            w = _box_of(whole, run, f"opt/{name}", prefix="")
            assert t.shape == w.shape, name
            err = float((t - w).abs().max())
            assert err <= 1e-5 * float(w.abs().max()), \
                (cell, run["coords"], name, err)
            n += 1
    assert n


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranks_holding_one_moe_box_hold_the_same_bits(worlds, cell):
    """After the two steps the ranks that hold the same box of a leaf hold
    the same parameters and optimizer state, bit for bit: the router, MLA's
    down-projections and norms, the KV heads two ranks share, the
    replicated norms, every leaf across the data axis, the row factor of
    a column-split leaf."""
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


@pytest.mark.parametrize("cell,model,want", [
    ("grok-tp4", 4, {"moe/moe/router", "moe/moe/router_bias",
                     "moe/attn/wk", "moe/attn/wv"}),
    ("grok-tp2", 2, {"moe/moe/router", "moe/moe/router_bias"}),
    ("grok6-tp4", 4, {"moe/moe/router", "moe/moe/router_bias",
                      "moe/attn/wk", "moe/attn/wv"}),
    ("deepseek-tp4", 4, {"moe/moe/router", "moe/moe/router_bias"})])
def test_moe_replica_leaves_come_from_the_specs_and_the_model(cell, model,
                                                              want):
    """The leaves of the sharded region several ranks of a model line hold
    (their gradients summed over the holders): the whole router and its
    bias (the MoE reads them for the rank's own slots), the KV heads
    ``kv_head_pad`` shares; not MLA's ``wq_a``, ``wkv_a``, ``q_ln`` and
    ``kv_ln`` (read before their latents' f: whole gradients), nor the
    replicated ``ln1``, ``ln2`` and ``final_norm`` outside the region."""
    cfg = _cfg(cell)
    for c in range(model):
        mesh = SimpleNamespace(shape={"data": 1, "model": model},
                               coords={"data": 0, "model": c})
        got = replica_leaves(cfg, mesh)
        assert set(got) == want, (c, got)
        for name, holders in got.items():
            pad = 2 if name.endswith(("wk", "wv")) else model
            assert holders == tuple(range(c // pad * pad,
                                          c // pad * pad + pad)), name


def test_sum_partials_passes_gradcheck(worlds):
    for run in worlds["gradcheck"]:
        assert run["ok"]
        for got, want in zip(run["out"], run["want"]):
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


# --------------------------------------------------------------- bytes

def _units(cfg) -> float:
    """All-reduces of [rows, SEQ, d_model] a rank joins in one ranked
    train step, in units of that size: the embedding's; per layer the
    attention's ``wo`` sum twice (the forward, the recomputed block under
    remat full) and its f once (GQA: the input; MLA: the latents q_lat,
    ckv, k_rope, narrower); the dense FFN's sum and f, or the MoE's
    stacked sum (the combine, and the shared experts' partial beside it)
    and f (the recomputation stops at the last saved tensor, before the
    FFN's or the experts' sum); the head's f."""
    if cfg.attention == "mla":
        m = cfg.mla
        attn = 2 + (m.q_lora_rank + m.kv_lora_rank + m.qk_rope_dim) \
            / cfg.d_model
    else:
        attn = 3
    moe = 1 + (1 if cfg.moe.n_shared_experts else 0) + 1
    n = 2 + sum(depth * (attn + (moe if seg == "moe" else 2))
                for seg, depth in tfm.layer_kinds(cfg).items())
    return n


def _adafactor_bytes(cfg, mesh) -> int:
    """(the bytes of the ranked Adafactor's all-reduces in one step, those
    of one element among them): for each leaf of the rank's shard with a
    split dim, the row sums of g² [.., rows] where its last dim splits,
    the column sums [.., cols] and the rows' ``vr`` sums where its second
    last does, and the clip sums, one a layer slice (kind ``scalar`` where
    that is one element); f32."""
    shard = dict(leaf_paths(tp.shard_tree(cfg, tfm.abstract_params(cfg),
                                          mesh)))
    total, scalars = 0, 0
    for name, sh in adafactor_shards(cfg, mesh).items():
        if not sh.split:
            continue
        p = shard[name]
        last, second = p.dim() - 1 in sh.split, p.dim() - 2 in sh.split
        if p.dim() >= 2 and last:
            total += p.numel() // p.shape[-1]
        if p.dim() >= 2 and second:
            total += p.numel() // p.shape[-2] + p.numel() // (
                p.shape[-1] * p.shape[-2])
        clips = p.shape[0] if p.dim() >= 3 else 1
        if clips > 1:
            total += clips
        else:
            scalars += 1
    return 4 * total, 4 * scalars


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_moe_step_bytes_per_peer(worlds, cell):
    """One step, to each other rank of the model line (kind ``reduce``):
    ``_units``' all-reduces of [rows, SEQ, d_model] f32; its f32 logits
    [rows, SEQ, V / model] (``gather``); the ranked Adafactor's statistics
    (``adafactor``, ``_adafactor_bytes``). To the other holders of a
    shared box of the sharded region (the router and its bias, shared KV
    heads) its gradient (``replica``). To the data peer every gradient's
    f32 bytes (``grad``). Scalars: the loss to the data peer, |g|² and the
    clip sums of unstacked leaves to the model peers."""
    _, data, model, _, opt, _ = CELLS[cell]
    cfg = _cfg(cell)
    runs = worlds[cell]
    rank_at = {tuple(r["coords"].values()): i for i, r in enumerate(runs)}
    rows = ROWS // data
    unit = rows * SEQ * cfg.d_model * 4
    for run in runs:
        d, c = run["coords"]["data"], run["coords"]["model"]
        mesh = SimpleNamespace(shape={"data": data, "model": model},
                               coords=run["coords"])
        model_peers = [rank_at[(d, m)] for m in range(model) if m != c]
        data_peers = [rank_at[(e, c)] for e in range(data) if e != d]
        want = {k: [0] * len(runs) for k in ("p2p", "reduce", "gather",
                                             "scalar", "grad", "replica",
                                             "adafactor")}
        grads = dict(leaf_paths(run["grads"]))
        for p in model_peers:
            want["reduce"][p] = round(_units(cfg) * unit)
            want["gather"][p] = rows * SEQ * cfg.vocab_size // model * 4
            want["scalar"][p] = 4
            if opt == "adafactor":
                want["adafactor"][p], clips = _adafactor_bytes(cfg, mesh)
                want["scalar"][p] += clips
        for p in data_peers:
            want["grad"][p] = sum(g.nbytes for g in grads.values())
            want["scalar"][p] = 4
        for name, holders in replica_leaves(cfg, mesh).items():
            for m in holders:
                if m != c:
                    want["replica"][rank_at[(d, m)]] += grads[name].nbytes
        for kind in ("grad", "adafactor"):
            if not any(want[kind]):
                del want[kind]
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


def test_ranked_adafactor_checkpoint_is_the_one_process_save(worlds):
    state = _assemble(_cfg(CKPT_CELL), worlds[CKPT_CELL])
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, STEP, state)
        name = f"step_{STEP:08d}"
        got, want = (os.path.join(p, name) for p in (worlds["ckpt"], d))
        names = sorted(os.listdir(os.path.join(want, "arrays")))
        assert sorted(os.listdir(os.path.join(got, "arrays"))) == names
        assert any("opt__vr__" in n for n in names)
        for f in ["manifest.json"] + [os.path.join("arrays", n)
                                      for n in names]:
            with open(os.path.join(got, f), "rb") as a, \
                    open(os.path.join(want, f), "rb") as b:
                assert a.read() == b.read(), f


def test_ranked_adafactor_checkpoint_restores_onto_another_mesh(worlds):
    for run in worlds["restore-tp4"]:
        assert run["restored"] and run["next"], run["coords"]


def test_adafactor_factor_boxes_follow_their_specs():
    """``shard_boxes`` of Adafactor's state on (1, 4): ``vr`` drops the
    last dim's entry of its parameter's box, ``vc`` the second last; a
    vector's ``vc`` (a [1] placeholder) is whole."""
    cfg = _cfg("grok-tp4")
    mesh = SimpleNamespace(shape={"data": 1, "model": 4},
                           coords={"data": 0, "model": 1})
    boxes = tp.shard_boxes(cfg, _state_like(cfg), mesh)
    full = slice(None)
    assert boxes["params/lm_head"] == (full, slice(128, 256))
    assert boxes["opt/vr/lm_head"] == (full,)
    assert boxes["opt/vc/lm_head"] == (slice(128, 256),)
    assert boxes["params/embed"] == (slice(128, 256), full)
    assert boxes["opt/vr/embed"] == (slice(128, 256),)
    assert boxes["opt/vc/embed"] == (full,)
    assert boxes["opt/vr/moe/moe/w_in"] == (full, slice(2, 4), full)
    assert boxes["opt/vc/final_norm"] == (full,)


# ----------------------------------------------------------- launcher

def test_train_launcher_trains_grok_on_ranks_with_adafactor(tmp_path):
    """The reduced grok-1-314b (Adafactor, bf16 weights) on 4 rank
    processes: the loss falls from step 0 to step 5 and the ranked
    checkpoint of step 5 is written."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "grok-1-314b", "--reduced", "--device", "cpu", "--host-devices",
         "4", "--ranks", "--steps", "6", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    assert out[0].startswith("mesh: {'data': 1, 'model': 4} on 4 rank "
                             "processes (cpu), arch=grok-1-314b ("), out[0]
    losses = [float(ln.split()[3]) for ln in out if ln.startswith("step")]
    assert len(losses) == 2 and losses[1] < losses[0], out
    assert out[-1] == "done"
    assert ckpt.latest_step(str(tmp_path)) == 5
    with open(os.path.join(tmp_path, "step_00000005", "manifest.json")) as f:
        assert '"opt/vc/moe/moe/w_in"' in f.read()


if __name__ == "__main__":
    if sys.argv[1] == "params":
        _write_params(sys.argv[2])
    else:
        _write_steps(sys.argv[2], sys.argv[3])
