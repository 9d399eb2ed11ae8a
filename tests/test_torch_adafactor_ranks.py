"""Adafactor on rank processes, on the CPU: on the pipelined ranks and over
Mamba-2's column pieces (``optimizer.ranked_adafactor_update``).

- The pipelined trainer (``make_pipeline_train_step`` on a ("pipe",
  "data", "model") mesh of ranks) on the reduced starcoder2-3b (4 layers,
  f32) with Adafactor, on (2, 1, 1) and (2, 2, 1) worlds: two steps' loss
  to 1e-6 and |g| to 1e-5 relative of the logical step's, each weight's
  first update to LR / 1000 of the logical one wherever the logical
  gradient exceeds 1e-5 of its leaf's max|g| (``test_torch_pipeline_ranks
  .py``'s gates), and each stage's factors after the two steps to 1e-5 of
  the leaf's largest: the column factor and the row mean of a stacked
  [L, d] leaf average over the layers the stages split, so they are sums
  over the pipe group, and every stage holds the same column factor.
- The reduced mamba2-1.3b (one SSM group that every rank of the axis
  reads) and zamba2-1.2b (5 layers) with Adafactor on (1, 2), (1, 4) and
  mamba2 on (2, 2), each rank drawing its shard of the seed-0 weights:
  the first step's loss (1e-6) and |g| (1e-5) against one process, each
  rank's gradient against its box of one process's at the Mamba-2 gate
  (4x one process's own gap between SSD chunk lengths 8 and 4, at least
  1e-5 of a leaf's max: ``test_torch_ssm_train_ranks.py``), and the update
  itself held apart from the gradient's noise: each rank's parameters
  after the step, and its boxes of the factors (a leaf of column pieces'
  column factor piece by piece), against the one-process
  ``adafactor_update`` (held to ``repro``'s in ``test_torch_train.py``)
  applied to the ranks' own gradients assembled whole, to 1e-5 of a
  leaf's largest update (beyond one f32 rounding of the parameter) and of
  its largest factor. A B or C column that several ranks hold counts once
  in the row means and the clip, and its holders hold the same bits.

- Both paths against ``repro``'s own Adafactor (its ``make_optimizer``
  serves every step builder), from this file's script mode on 4 forced
  host devices. The (2, 1, 1) ranks against its jitted
  ``make_pipeline_train_step`` on a (2, 1, 1) ``jax.sharding.Mesh``: two
  steps' loss and |g|, the parameters after the first and the factors
  after the second, at the pipelined gates above. The (1, 4) mamba2 ranks
  against its jitted ``make_train_step`` and gradient with params and
  factors placed by its specs on an Auto-axis (1, 4) mesh: the loss and
  |g|, each rank's gradient at the Mamba-2 gate; and, the update held
  apart from that gradient noise as above, its parameters and factors
  against ``repro``'s ``adafactor_update`` of the ranks' own gradients
  assembled whole (1e-5 of a leaf's largest update beyond one f32
  rounding, and of its largest factor).

Every run starts from ``repro``'s seed-0 parameters (an ``.npz`` of the
script mode). The rank functions live here (a spawned child imports this
module, which imports nothing of JAX at its top). Each world is spawned
once for the module: one of 4 ranks, one of 2.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.dist import ranks
from repro_torch.dist import tensor_parallel as tp
from repro_torch.launch.mesh import Mesh, make_pipeline_mesh
from repro_torch.models.convert import (params_from_reference,
                                        shard_params_from_reference)
from repro_torch.models.layers import take_box
from repro_torch.models.transformer import abstract_params
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import adafactor_init, adafactor_update
from repro_torch.train.train_step import (loss_and_grads,
                                          make_pipeline_loss,
                                          make_pipeline_train_step,
                                          make_train_step, pipeline_rows,
                                          pipeline_shard, ranked_grads,
                                          value_and_grads)
from repro_torch.train.tree import leaf_paths, tree_map, unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, SEQ, MICRO, LR = 8, 16, 2, 1e-3
PIPE_CELLS = {"pipe2": (2, 1), "pipe2-dp2": (2, 2)}   # (stages, data)
PIPE, MAMBA, ZAMBA = "starcoder2-3b", "mamba2-1.3b", "zamba2-1.2b"
SSM_CELLS = {"mamba2-tp2": (MAMBA, 1, 2), "mamba2-tp4": (MAMBA, 1, 4),
             "mamba2-dp2-tp2": (MAMBA, 2, 2), "zamba2-tp2": (ZAMBA, 1, 2),
             "zamba2-tp4": (ZAMBA, 1, 4)}
NOISE, TOL = 4.0, 1e-5
ULP = torch.finfo(torch.float32).eps      # an f32 rounding, relative


def _config(arch, reduce=reduced, get=get_config):
    """``arch``'s config here, of either package (``reduce`` and ``get``:
    its ``reduced`` and ``get_config``): f32 compute and Adafactor; the
    pipelined starcoder2-3b with 4 layers and a vocabulary of 128, zamba2
    with 5 layers."""
    if arch == PIPE:
        return reduce(get(arch), n_layers=4, vocab_size=128,
                      compute_dtype="float32", optimizer="adafactor")
    cfg = reduce(get(arch), compute_dtype="float32", optimizer="adafactor")
    return dataclasses.replace(cfg, n_layers=5) if arch == ZAMBA else cfg


def _pipe_cfg():
    return _config(PIPE)


def _ssm_cfg(arch):
    return _config(arch)


def _batch_np(cfg, rows=ROWS):
    """Labels masked unequally between the data ranks (numpy)."""
    b = SyntheticLM(cfg.vocab_size, SEQ, rows, learnable=True,
                    seed=3).batch_at(0)
    b["labels"] = b["labels"].copy()
    b["labels"][0, ::3] = -1
    b["labels"][1, :7] = -1
    return b


def _batch(cfg, rows=ROWS):
    return {k: torch.from_numpy(v) for k, v in _batch_np(cfg, rows).items()}


def _nested(items):
    """``{"a/b": leaf}`` as ``{"a": {"b": leaf}}``."""
    tree = {}
    for name, v in items.items():
        *path, last = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _npz_tree(path, prefix):
    """The leaves of the ``.npz`` under ``prefix/``, as a tree (numpy)."""
    with np.load(path) as f:
        return _nested({k[len(prefix) + 1:]: f[k] for k in f.files
                        if k.startswith(prefix + "/")})


def _weights(path, arch):
    """``repro``'s seed-0 parameters of ``arch`` (numpy)."""
    return _npz_tree(path, f"params-{arch}")


# ------------------------------------------------------ rank functions

def pipe_rank(rank, world, ref_path, stages, *, device):
    """Two pipelined Adafactor steps from the seed-0 weights on one batch:
    their metrics, the parameters after the first, the state after the
    second and where each leaf lies."""
    cfg = _pipe_cfg()
    mesh = make_pipeline_mesh(stages, world, device, group=dist.group.WORLD)
    params = pipeline_shard(cfg, params_from_reference(
        _weights(ref_path, PIPE), device), mesh)
    step = make_pipeline_train_step(cfg, mesh, lr=LR, n_micro=MICRO)
    batch = _batch(cfg)
    mesh.transport.reset()
    params, opt, first = step(params, adafactor_init(params), batch)
    sent = {k: list(v) for k, v in mesh.transport.bytes.items()}
    after = tree_map(torch.clone, params)
    params, opt, second = step(params, opt, batch)
    state = {"params": params, "opt": opt}
    return {"coords": mesh.coords, "metrics": [first, second],
            "after": after, "state": state,
            "rows": pipeline_rows(cfg, state, mesh), "bytes": sent}


def ssm_rank(rank, world, ref_path, cell, *, device):
    """One Adafactor step of ``cell`` on this rank's shard of the seed-0
    weights: the ranked gradients, the metrics, the parameters before and
    after, the factors and each leaf's box."""
    arch, data, model = SSM_CELLS[cell]
    cfg = _ssm_cfg(arch)
    mesh = Mesh((data, model), ("data", "model"), device,
                group=dist.group.WORLD)
    params = shard_params_from_reference(cfg, _weights(ref_path, arch),
                                         mesh, device)
    batch = _batch(cfg, 4)
    _, grads = ranked_grads(cfg, mesh)(params, batch)
    before = tree_map(torch.clone, params)
    step = make_train_step(cfg, lr=LR, mesh=mesh)
    params, opt, metrics = step(params, adafactor_init(params), batch)
    like = abstract_params(cfg)
    return {"coords": mesh.coords, "grads": grads, "metrics": metrics,
            "before": before, "params": params, "opt": opt,
            "boxes": tp.shard_boxes(cfg, {"params": like,
                                          "opt": adafactor_init(like)},
                                    mesh)}


# ------------------------------------------------------------- worlds

def _write_reference(path):
    """``repro``'s seed-0 parameters of each arch and its Adafactor steps
    on them (this file's script mode, on 4 host devices): the pipelined
    step on a (2, 1, 1) mesh twice, and mamba2's step once on an Auto-axis
    (1, 4) mesh with params and factors placed by its specs, as its
    launcher places them. Per cell: the metrics, the parameters after the
    first step and the factors after the last."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.configs import base as jx_base
    from repro.configs.registry import get_config as jx_get_config
    from repro.dist import ctx as jx_ctx
    from repro.dist import pipeline as jx_pipe
    from repro.dist import sharding as jx_sh
    from repro.models import transformer as jx_tfm
    from repro.train.optimizer import make_optimizer, opt_state_specs
    from repro.train.train_step import make_pipeline_train_step
    from repro.train.train_step import make_train_step as jx_step

    # jax 0.9 types a scan's carry by the mesh axes it varies over, and
    # the pipeline's zeros-initialised hand-off carry then fails to trace
    # (ROADMAP's reference caveats: tests/test_ptg_linalg.py's
    # pipeline_train_step case). The jax the reference was written for
    # had no such check: its shard_map runs here without it, computing
    # the same values.
    jx_pipe.shard_map = functools.partial(jax.shard_map, check_vma=False)
    init, _ = make_optimizer("adafactor")
    out, weights, jcfgs = {}, {}, {}
    for arch in (PIPE, MAMBA, ZAMBA):
        jcfgs[arch] = _config(arch, jx_base.reduced, jx_get_config)
        weights[arch] = jx_tfm.init_params(jcfgs[arch], jax.random.key(0))
        for name, a in leaf_paths(jax.tree.map(np.asarray, weights[arch])):
            out[f"params-{arch}/{name}"] = a

    def keep(cell, s, params, opt, m):
        out[f"{cell}/loss{s}"] = np.asarray(m["loss"])
        out[f"{cell}/grad_norm{s}"] = np.asarray(m["grad_norm"])
        if s == 0:
            for name, a in leaf_paths(jax.tree.map(np.asarray, params)):
                out[f"{cell}/after/{name}"] = a
        for key in ("vr", "vc"):
            for name, a in leaf_paths(jax.tree.map(np.asarray,
                                                   getattr(opt, key))):
                out[f"{cell}/{key}/{name}"] = a

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(2, 1, 1),
                             ("pipe", "data", "model"))
    step = jax.jit(make_pipeline_train_step(jcfgs[PIPE], mesh, lr=LR,
                                            n_micro=MICRO))
    params = weights[PIPE]
    opt = init(params)
    batch = {k: jnp.asarray(v) for k, v in _batch_np(_pipe_cfg()).items()}
    for s in (0, 1):
        params, opt, m = step(params, opt, batch)
        keep("pipe2", s, params, opt, m)

    jcfg = jcfgs[MAMBA]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                             ("data", "model"))
    axes = jx_sh.batch_axis(mesh, 4)
    jx_ctx.set_batch_axes(axes)
    jx_ctx.set_seq_shard(SEQ % 4 == 0)
    try:
        with jx_ctx.use_mesh(mesh):
            p_abs = jx_tfm.abstract_params(jcfg)
            p_specs = jx_sh.sanitize_specs(
                jx_sh.param_specs(jcfg, model_axis=4), p_abs, mesh)
            o_specs = jx_sh.sanitize_specs(
                opt_state_specs(p_specs, "adafactor", p_abs),
                jax.eval_shape(init, p_abs), mesh)
            params = jax.device_put(weights[MAMBA],
                                    jx_sh.named_shardings(mesh, p_specs))
            opt = jax.device_put(init(params),
                                 jx_sh.named_shardings(mesh, o_specs))
            b = {k: jax.device_put(jnp.asarray(v),
                                   NamedSharding(mesh, JP(axes)))
                 for k, v in _batch_np(_ssm_cfg(MAMBA), 4).items()}
            _, grads = jax.jit(jax.value_and_grad(
                lambda p, b: jx_tfm.lm_loss(jcfg, p, b)))(params, b)
            for name, a in leaf_paths(jax.tree.map(np.asarray, grads)):
                out[f"mamba2-tp4/grad/{name}"] = a
            params, opt, m = jax.jit(jx_step(jcfg, lr=LR))(params, opt, b)
            keep("mamba2-tp4", 0, params, opt, m)
    finally:
        jx_ctx.set_batch_axes(None)
        jx_ctx.set_seq_shard(False)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s outputs, from this file's script mode on 4 forced host
    devices; ``path`` is the ``.npz`` every run reads its weights from."""
    path = tmp_path_factory.mktemp("jax_adafactor_ranks") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return str(path)


@pytest.fixture(scope="module")
def worlds(reference):
    """The 4-rank world ((2, 2, 1) pipelined, the (1, 4) and (2, 2) ssm
    cells) and the 2-rank one ((2, 1, 1), the (1, 2) cells)."""
    out = {}
    for world in (4, 2):
        pipe = [c for c, (s, d) in PIPE_CELLS.items() if s * d == world]
        ssm = [c for c, (_, d, m) in SSM_CELLS.items() if d * m == world]
        got = ranks.spawn_ranks(ranks.run_jobs, world, [
            (pipe_rank, (reference, PIPE_CELLS[c][0]), {}) for c in pipe] + [
            (ssm_rank, (reference, c), {}) for c in ssm], device="cpu",
            timeout=600)
        for i, cell in enumerate(pipe + ssm):
            out[cell] = [r[i] for r in got]
    return out


# ------------------------------------------------------- pipelined ranks

def _logical(ref_path, stages, data):
    """The logical pipelined step on the same batch, microbatches of the
    same rows: the first step's gradients, then two steps: their metrics,
    the parameters after the first and the state after the second."""
    cfg = _pipe_cfg()
    mesh = make_pipeline_mesh(stages, stages * data, "cpu")
    params = params_from_reference(_weights(ref_path, PIPE), "cpu")
    _, grads = value_and_grads(
        make_pipeline_loss(cfg, mesh, n_micro=MICRO * data), params,
        _batch(cfg))
    step = make_pipeline_train_step(cfg, mesh, lr=LR, n_micro=MICRO * data)
    params, opt, first = step(params, adafactor_init(params), _batch(cfg))
    after = tree_map(torch.clone, params)
    params, opt, second = step(params, opt, _batch(cfg))
    return {"metrics": [first, second], "after": after, "grads": grads,
            "state": {"params": params, "opt": opt}}


def _part(whole, name, row, like):
    t = dict(leaf_paths(whole))[name]
    return (t[row:row + like.shape[0]] if like.dim() and
            "dense" in name.split("/") and t.shape != like.shape else t)


@pytest.fixture(scope="module")
def logical(reference):
    return {cell: _logical(reference, *PIPE_CELLS[cell])
            for cell in PIPE_CELLS}


@pytest.mark.parametrize("cell", list(PIPE_CELLS))
def test_pipelined_adafactor_steps_match_logical(worlds, logical, cell):
    want = logical[cell]
    for run in worlds[cell]:
        for got, one in zip(run["metrics"], want["metrics"]):
            assert abs(float(got["loss"]) - float(one["loss"])) <= 1e-6 \
                * float(one["loss"]), run["coords"]
            assert abs(float(got["grad_norm"]) - float(one["grad_norm"])) \
                <= 1e-5 * float(one["grad_norm"]), run["coords"]
        assert int(run["state"]["opt"].step) == 2
        for name, p in leaf_paths({"params": run["after"]}):
            row = run["rows"][name]
            w = _part({"params": want["after"]}, name, row, p)
            g = _part({"params": want["grads"]}, name, row, p).abs()
            moved = g > 1e-5 * g.max()
            err = float(((p - w).abs() * moved).max())
            assert moved.any() and err <= LR * 1e-3, (name, err)


@pytest.mark.parametrize("cell", list(PIPE_CELLS))
def test_pipelined_adafactor_factors_span_the_stages(worlds, logical, cell):
    """After two steps each stage's row and column factors are its part of
    the logical ones (a [L, d] leaf's column factor whole, the same bits
    on every stage), and the stages summed statistics under their own
    kind."""
    want = logical[cell]["state"]
    runs = worlds[cell]
    for run in runs:
        for name, t in leaf_paths(run["state"]):
            keys = name.split("/")
            if keys[1] not in ("vr", "vc"):
                continue
            w = _part(want, name, run["rows"][name], t)
            assert t.shape == w.shape, name
            err = float((t - w).abs().max() / w.abs().max().clamp(
                min=1e-30))
            assert err <= 1e-5, (cell, run["coords"], name, err)
        assert sum(run["bytes"]["adafactor"]) > 0
    for name, t in leaf_paths(runs[0]["state"]["opt"].vc):
        if t.dim() < 2 and "dense" in name.split("/"):
            assert all(torch.equal(t, dict(leaf_paths(
                r["state"]["opt"].vc))[name]) for r in runs), name


# -------------------------------------------------- Mamba-2's column pieces

def _put(whole: torch.Tensor, box, t: torch.Tensor) -> None:
    """Write a rank's ``t`` at its ``box`` of ``whole`` (a list of column
    boxes piece by piece)."""
    if not isinstance(box, list):
        whole[box] = t
        return
    at = 0
    for piece in box:
        width = piece[-1].stop - piece[-1].start
        whole[piece] = t[..., at:at + width]
        at += width


def _assembled(cfg, runs):
    """The whole gradient tree of the ranks' boxes."""
    whole = {name: torch.zeros(t.shape, dtype=t.dtype) for name, t in
             leaf_paths(abstract_params(cfg))}
    for run in runs:
        for name, g in leaf_paths(run["grads"]):
            _put(whole[name], run["boxes"][f"params/{name}"], g)
    return whole


def _gap(a, b) -> float:
    return max(float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30)
               for (_, x), (_, y) in zip(leaf_paths(a), leaf_paths(b)))


def _unflat(like, flat):
    return unflatten(like, [flat[name] for name, _ in leaf_paths(like)])


@pytest.fixture(scope="module")
def one_process(reference):
    """Per ssm arch (its cells share it), one process on the same weights
    and batch: the loss, |g| and gradients, and the Mamba-2 gradient
    gate."""
    by_arch = {}
    for arch in sorted({arch for arch, _, _ in SSM_CELLS.values()}):
        cfg = _ssm_cfg(arch)
        batch = _batch(cfg, 4)
        params = params_from_reference(_weights(reference, arch), "cpu")
        loss, grads = loss_and_grads(cfg, params, batch)
        gap = 0.0
        for chunk in ("8", "4"):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("REPRO_SSD_CHUNK", chunk)
                gap = max(gap, _gap(grads, loss_and_grads(cfg, params,
                                                          batch)[1]))
        _, _, metrics = make_train_step(cfg, lr=LR)(
            tree_map(torch.clone, params),
            adafactor_init(params), batch)
        by_arch[arch] = {"cfg": cfg, "loss": loss, "grads": grads,
                         "metrics": metrics, "params": params,
                         "tol": max(TOL, NOISE * gap)}
    return {cell: by_arch[arch] for cell, (arch, _, _) in SSM_CELLS.items()}


@pytest.mark.parametrize("cell", list(SSM_CELLS))
def test_column_piece_adafactor_step_matches_one_process(worlds, one_process,
                                                         cell):
    """The first step's loss and |g|, and each rank's gradient of every
    leaf against its box of one process's, at the Mamba-2 gate."""
    want = one_process[cell]
    for run in worlds[cell]:
        got = run["metrics"]
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-6 \
            * float(want["loss"]), run["coords"]
        assert abs(float(got["grad_norm"]) - float(
            want["metrics"]["grad_norm"])) <= 1e-5 * float(
            want["metrics"]["grad_norm"]), run["coords"]
        for name, g in leaf_paths(run["grads"]):
            w = take_box(dict(leaf_paths(want["grads"]))[name],
                         run["boxes"][f"params/{name}"])
            err = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
            assert err <= want["tol"], (cell, run["coords"], name, err)


@pytest.mark.parametrize("cell", list(SSM_CELLS))
def test_column_piece_adafactor_update_is_the_whole_leaves(worlds,
                                                           one_process,
                                                           cell):
    """Each rank's update and factors against the one-process update of
    the ranks' own gradients, assembled (``adafactor_update``, which
    ``test_torch_train.py`` holds to ``repro``'s)."""
    want = one_process[cell]
    cfg, runs = want["cfg"], worlds[cell]
    grads = _unflat(abstract_params(cfg), _assembled(cfg, runs))
    params = tree_map(torch.clone, want["params"])
    port, state = adafactor_update(params, grads, adafactor_init(params),
                                   lr=LR)
    for run in runs:
        for (name, before), (_, p) in zip(leaf_paths(run["before"]),
                                          leaf_paths(run["params"])):
            w = take_box(dict(leaf_paths(port))[name],
                         run["boxes"][f"params/{name}"])
            # beyond one rounding of the parameter (p - lr·u rounds once
            # here, lr·u first there)
            off = (p - w).abs() - ULP * w.abs()
            err = float(off.max() / (w - before).abs().max())
            assert err <= 1e-5, (cell, run["coords"], name, err)
            for key, tree, mine in (("vr", state.vr, run["opt"].vr),
                                    ("vc", state.vc, run["opt"].vc)):
                t = dict(leaf_paths(mine))[name]
                w = take_box(dict(leaf_paths(tree))[name],
                             run["boxes"][f"opt/{key}/{name}"])
                err = float((t - w).abs().max()
                            / w.abs().max().clamp(min=1e-30))
                assert err <= 1e-5, (cell, run["coords"], key, name, err)


@pytest.mark.parametrize("cell", list(SSM_CELLS))
def test_column_piece_holders_hold_the_same_bits(worlds, cell):
    """A column piece that several ranks hold (the B and C columns of the
    group every rank reads) has the same bits on each after the step, in
    the parameters and in the column factor."""
    seen, compared = {}, 0
    for run in worlds[cell]:
        for key, tree in (("params", run["params"]),
                          ("opt/vc", run["opt"].vc)):
            for name, t in leaf_paths(tree):
                box = run["boxes"][f"{key}/{name}"]
                at = 0
                for piece in box if isinstance(box, list) else ():
                    width = piece[-1].stop - piece[-1].start
                    cols = t[..., at:at + width]
                    at += width
                    k = (key, name, run["coords"]["data"], repr(piece))
                    if k in seen:
                        assert torch.equal(seen[k], cols), k
                        compared += 1
                    seen[k] = cols
    assert compared, cell


# ------------------------------------------------------ against repro

def _ref_tree(path, prefix, like):
    """The ``.npz``'s leaves under ``prefix`` as tensors in ``like``'s
    tree."""
    flat = _npz_tree(path, prefix)
    return params_from_reference(_nested(
        {name: dict(leaf_paths(flat))[name] for name, _ in leaf_paths(like)}),
        "cpu")


def _ref_metrics(path, cell, steps):
    with np.load(path) as f:
        return [(float(f[f"{cell}/loss{s}"]), float(f[f"{cell}/grad_norm{s}"]))
                for s in range(steps)]


def test_pipelined_adafactor_matches_the_reference(worlds, reference,
                                                   logical):
    """Each rank of the (2, 1, 1) world against ``repro``'s pipelined step
    on a (2, 1, 1) mesh: both steps' loss and |g|, the parameters after
    the first (where the logical gradient moves them) and the factors after
    the second (a [L, d] leaf's column factor whole on each stage)."""
    cfg = _pipe_cfg()
    like = abstract_params(cfg)
    want = {"params": _ref_tree(reference, "pipe2/after", like),
            "opt": {"vr": _ref_tree(reference, "pipe2/vr",
                                    adafactor_init(like).vr),
                    "vc": _ref_tree(reference, "pipe2/vc",
                                    adafactor_init(like).vc)}}
    grads = {"params": logical["pipe2"]["grads"]}
    for run in worlds["pipe2"]:
        for got, (loss, norm) in zip(run["metrics"],
                                     _ref_metrics(reference, "pipe2", 2)):
            assert abs(float(got["loss"]) - loss) <= 1e-6 * loss
            assert abs(float(got["grad_norm"]) - norm) <= 1e-5 * norm
        for name, p in leaf_paths({"params": run["after"]}):
            row = run["rows"][name]
            w = _part(want, name, row, p)
            g = _part(grads, name, row, p).abs()
            moved = g > 1e-5 * g.max()
            err = float(((p - w).abs() * moved).max())
            assert moved.any() and err <= LR * 1e-3, (name, err)
        state = run["state"]
        for key in ("vr", "vc"):
            for name, t in leaf_paths({"opt": {key: getattr(
                    state["opt"], key)}}):
                w = _part(want, name, run["rows"][name], t)
                err = float((t - w).abs().max() / w.abs().max().clamp(
                    min=1e-30))
                assert err <= 1e-5, (run["coords"], name, err)


@pytest.fixture(scope="module")
def reference_update(worlds, reference, one_process):
    """``repro``'s ``adafactor_update`` (jitted, in this process) of its
    seed-0 mamba2 parameters by the (1, 4) ranks' own gradients, assembled
    whole, from a fresh state: the parameters and factors the ranks must
    hold (tensors)."""
    import jax

    from repro.train.optimizer import adafactor_init as jx_init
    from repro.train.optimizer import adafactor_update as jx_update

    cell = "mamba2-tp4"
    grads = _nested({k: v.numpy() for k, v in _assembled(
        one_process[cell]["cfg"], worlds[cell]).items()})
    params, state = jax.jit(lambda p, g: jx_update(p, g, jx_init(p),
                                                   lr=LR))(
        _weights(reference, MAMBA), grads)
    return tuple(params_from_reference(jax.tree.map(np.asarray, t), "cpu")
                 for t in (params, state.vr, state.vc))


def test_column_piece_adafactor_matches_the_reference(worlds, reference,
                                                      reference_update,
                                                      one_process):
    """Each rank of the (1, 4) mamba2 cell against ``repro``'s sharded
    step on a (1, 4) mesh: the loss and |g|, and each rank's gradient
    against its box of ``repro``'s sharded gradient at the Mamba-2 gate;
    and its parameters and factors after the step against ``repro``'s
    ``adafactor_update`` of the ranks' own gradients (the update held apart
    from the gradient's noise, as above), to 1e-5 of a leaf's largest
    update beyond one f32 rounding and of its largest factor."""
    cell = "mamba2-tp4"
    want = one_process[cell]
    like = abstract_params(want["cfg"])
    (loss, norm), = _ref_metrics(reference, cell, 1)
    ref_grads = _ref_tree(reference, f"{cell}/grad", like)
    params, vr, vc = reference_update
    for run in worlds[cell]:
        got = run["metrics"]
        assert abs(float(got["loss"]) - loss) <= 1e-6 * loss, run["coords"]
        assert abs(float(got["grad_norm"]) - norm) <= 1e-5 * norm, \
            run["coords"]
        for name, g in leaf_paths(run["grads"]):
            w = take_box(dict(leaf_paths(ref_grads))[name],
                         run["boxes"][f"params/{name}"])
            err = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
            assert err <= want["tol"], (run["coords"], name, err)
        for (name, before), (_, p) in zip(leaf_paths(run["before"]),
                                          leaf_paths(run["params"])):
            w = take_box(dict(leaf_paths(params))[name],
                         run["boxes"][f"params/{name}"])
            off = (p - w).abs() - ULP * w.abs()
            err = float(off.max() / (w - before).abs().max())
            assert err <= 1e-5, (run["coords"], name, err)
        for key, tree, mine in (("vr", vr, run["opt"].vr),
                                ("vc", vc, run["opt"].vc)):
            for name, t in leaf_paths(mine):
                w = take_box(dict(leaf_paths(tree))[name],
                             run["boxes"][f"opt/{key}/{name}"])
                err = float((t - w).abs().max()
                            / w.abs().max().clamp(min=1e-30))
                assert err <= 1e-5, (run["coords"], key, name, err)


if __name__ == "__main__":
    _write_reference(sys.argv[1])
