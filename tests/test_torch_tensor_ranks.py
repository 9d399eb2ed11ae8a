"""Tensor-parallel serving on rank processes, on the CPU: the ("data",
"model") mesh laid on spawned processes joined into a gloo group
(``launch.mesh.Mesh(..., group=)``, ``dist.tensor_parallel``).

The reduced yi-6b (2 layers, 4 query heads over 2 KV heads of 32, d_model
128, vocab 512, f32 compute) on a (1, 2), a (2, 2) and a (1, 4) mesh of
ranks, and with tied embeddings on (1, 2). The (1, 4) mesh is the half-head
case: ``kv_head_pad`` is 2, so ``param_specs`` splits ``wk``/``wv`` inside
a KV head and each rank holds the whole KV head of its padded cache shard.

- ``forward`` logits [B, S, V], ``prefill``, and 8 greedy serve steps from
  a cache of seeded contents against ``repro``'s ``forward`` and
  ``decode_step`` jitted on 4 forced host devices with its params and
  cache placed by ``param_specs``/``cache_specs`` on an Auto-axis
  ``jax.sharding.Mesh`` (an ``.npz`` from this file's script mode):
  max|port - repro| / max|repro| <= 1e-4, the greedy tokens equal;
- the same against the one-process port on the same inputs (the tensor-
  parallel sums in another order only): <= 1e-5, tokens equal;
- each rank's weights, drawn as shards (``init_shard_params``) and carried
  from ``repro``'s numpy parameters (``shard_params_from_reference``), bit
  for bit the slices of the whole trees, taken here leaf by leaf by name;
- each rank's cache shard after the steps: the one-process cache's head
  and row slice, bit for bit where no step wrote and within 1e-5 where one
  did (the new keys and values come from the residual stream);
- the bytes each rank sends each peer, by kind, in ``forward``,
  ``prefill`` and a step equal their formula;
- the launcher decodes on ranks (also the ssm and encdec families, and
  seamless-m4t-large-v2 on 4 ranks) and refuses what the model axis on
  ranks does not run; ``check_tp`` passes every family, full-size
  seamless-m4t-large-v2 on 4 with its embedding and head split on d_model
  (``tests/test_torch_dshard_ranks.py`` serves that layout).

The rank functions live here (a spawned child imports this module, which
imports nothing of JAX at its top). Each world is spawned once for the
module: one of 2 ranks ((1, 2) untied and tied), one of 4 ((2, 2), (1,
4)).
"""

import ast
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.dist import ranks
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.ctx import launch_mesh
from repro_torch.dist.sharding import P, kv_head_pad
from repro_torch.launch.mesh import Mesh, make_dev_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import (params_from_reference,
                                        shard_params_from_reference)
from repro_torch.serve.decode import make_serve_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# batch, prompt, cache positions, positions filled, greedy steps
B, S, MAX_SEQ, P0, STEPS = 4, 16, 24, 12, 8
# name -> (data, model, tied embeddings)
CELLS = {"tp2": (1, 2, False), "tp2-tied": (1, 2, True),
         "dp2-tp2": (2, 2, False), "tp4": (1, 4, False)}
WORLDS = {2: ["tp2", "tp2-tied"], 4: ["dp2-tp2", "tp4"]}
TOL_REF, TOL_PORT = 1e-4, 1e-5


def _cfg(tie):
    return reduced(get_config("yi-6b"), compute_dtype="float32",
                   tie_embeddings=tie)


def _inputs(tie):
    """The prompt [B, S], the cache's keys and values [2, L, B, Hkv,
    MAX_SEQ, hd] (seeded at positions < P0, zeros after) and the first
    decode tokens [B], from numpy with a seed."""
    cfg = _cfg(tie)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    shape = (2, cfg.n_layers, B, cfg.n_kv_heads, MAX_SEQ, cfg.head_dim)
    kv = np.zeros(shape, np.float32)
    kv[..., :P0, :] = rng.standard_normal((*shape[:4], P0, shape[5]))
    return toks, kv, rng.integers(0, cfg.vocab_size, (B,))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k],
                                                         f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _unflat(items):
    tree = {}
    for name, v in items.items():
        *path, last = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _rows(mesh):
    """This rank's rows of the batch: split over "data"."""
    n = B // mesh.shape["data"]
    return slice(mesh.coords["data"] * n, (mesh.coords["data"] + 1) * n)


def _sent(net):
    return {k: list(v) for k, v in net.bytes.items()}


# ------------------------------------------------------ rank functions

def tp_cell(rank, world, ref_path, data, model, tie, *, device):
    """One cell on this rank: its weights carried from ``repro``'s and
    drawn as shards, then under ``launch_mesh`` its rows' ``forward`` and
    ``prefill`` logits and 8 greedy serve steps from its shard of the
    seeded cache, with the bytes each sent by kind, and its cache after."""
    cfg = _cfg(tie)
    with np.load(ref_path) as f:
        tree = _unflat({k.split("/", 1)[1]: f[k] for k in f.files
                        if k.startswith(f"params-{int(tie)}/")})
    mesh = Mesh((data, model), ("data", "model"), device,
                group=dist.group.WORLD)
    params = shard_params_from_reference(cfg, tree, mesh, device)
    drawn = tp.init_shard_params(cfg, mesh, seed=0, device=device)
    toks, kv, first = _inputs(tie)
    rows = _rows(mesh)
    pad = kv_head_pad(cfg, model)
    net = mesh.transport
    out = {"coords": mesh.coords, "params": params, "drawn": drawn}
    with torch.inference_mode(), launch_mesh(mesh, global_batch=B):
        tokens = torch.from_numpy(toks[rows]).to(device)
        net.reset()
        out["forward"] = tfm.forward(cfg, params, tokens=tokens)[0]
        out["forward_bytes"] = _sent(net)
        net.reset()
        out["prefill"] = tfm.prefill(cfg, params, tokens=tokens)
        out["prefill_bytes"] = _sent(net)
        whole = tfm.DecodeCache(pos=P0, layers={"dense": tuple(
            torch.from_numpy(np.repeat(t, pad, axis=2)).to(device)
            for t in kv)})
        cache = tp.shard_cache(cfg, whole, mesh)
        step = make_serve_step(cfg)
        tok = torch.from_numpy(first[rows]).to(device)
        logits, tokens_out = [], []
        net.reset()
        for _ in range(STEPS):
            tok, lg, cache = step(params, tok, cache)
            logits.append(lg)
            tokens_out.append(tok)
        out["step_bytes"] = _sent(net)
    out.update(steps=torch.stack(logits), tokens=torch.stack(tokens_out),
               cache=cache.layers["dense"], pos=cache.pos)
    return out


# ------------------------------------------------------------- worlds

def _write_reference(path):
    """``repro``'s parameters (seed 0, untied and tied) and, per cell, its
    jitted ``forward`` logits, 8 greedy ``decode_step``s' logits and
    tokens and the cache after them, with params and cache placed by its
    specs on an Auto-axis mesh of the cell's shape over the 4 host devices
    (this file's script mode)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jx_base
    from repro.configs.registry import get_config as jx_get_config
    from repro.dist import ctx as jx_ctx
    from repro.dist import sharding as jx_sh
    from repro.models import transformer as jx_tfm

    out = {}

    def jcfg_of(tie):
        return jx_base.reduced(jx_get_config("yi-6b"),
                               compute_dtype="float32", tie_embeddings=tie)

    for tie in (False, True):
        jp = jx_tfm.init_params(jcfg_of(tie), jax.random.key(0))
        for name, a in _flat(jax.tree.map(np.asarray, jp)):
            out[f"params-{int(tie)}/{name}"] = a
    for cell, (data, model, tie) in CELLS.items():
        jcfg = jcfg_of(tie)
        jp = jx_tfm.init_params(jcfg, jax.random.key(0))
        toks, kv, first = _inputs(tie)
        pad = jx_sh.kv_head_pad(jcfg, model)
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:data * model]).reshape(data, model),
            ("data", "model"))
        axes = jx_sh.batch_axis(mesh, B)
        jx_ctx.set_batch_axes(axes)
        try:
            with jx_ctx.use_mesh(mesh):
                p_specs = jx_sh.sanitize_specs(
                    jx_sh.param_specs(jcfg, model_axis=model),
                    jx_tfm.abstract_params(jcfg), mesh)
                params = jax.device_put(jp, jx_sh.named_shardings(mesh,
                                                                  p_specs))
                logits = jax.jit(lambda p, t: jx_tfm.forward(
                    jcfg, p, tokens=t)[0])(params, jnp.asarray(toks))
                cache = jx_tfm.DecodeCache(
                    pos=jnp.asarray(P0, jnp.int32), layers={"dense": tuple(
                        jnp.asarray(np.repeat(t, pad, axis=2)) for t in kv)})
                shapes = jax.eval_shape(lambda: cache)
                c_specs = jx_sh.sanitize_specs(jx_sh.cache_specs(
                    jcfg, shapes, axes, model_axis=model), shapes, mesh)
                cache = jax.tree.map(
                    lambda x, s: jax.device_put(x, jax.NamedSharding(mesh,
                                                                     s)),
                    cache, c_specs, is_leaf=lambda x: hasattr(x, "shape"))
                step = jax.jit(lambda p, t, c: jx_tfm.decode_step(jcfg, p, t,
                                                                  c))
                tok = jnp.asarray(first, jnp.int32)
                steps, tokens = [], []
                for _ in range(STEPS):
                    lg, cache = step(params, tok, cache)
                    tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
                    steps.append(np.asarray(lg))
                    tokens.append(np.asarray(tok))
        finally:
            jx_ctx.set_batch_axes(None)
        out[f"{cell}/forward"] = np.asarray(logits)
        out[f"{cell}/steps"] = np.stack(steps)
        out[f"{cell}/tokens"] = np.stack(tokens)
        out[f"{cell}/k"], out[f"{cell}/v"] = map(np.asarray,
                                                 cache.layers["dense"])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s outputs, from this file's script mode on 4 forced host
    devices; ``path`` is the ``.npz`` the ranks read the weights from."""
    path = tmp_path_factory.mktemp("jax_tensor_parallel") / "outputs.npz"
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
def worlds(reference):
    """Each world spawned once, its cells run in turn: cell -> the ranks'
    results in rank order."""
    out = {}
    for world, cells in WORLDS.items():
        runs = ranks.spawn_ranks(ranks.run_jobs, world, [
            (tp_cell, (reference["path"], *CELLS[c]), {}) for c in cells],
            device="cpu", timeout=300)
        for i, c in enumerate(cells):
            out[c] = [r[i] for r in runs]
    return out


def _weights(reference, tie):
    """``repro``'s parameters as numpy arrays and as the port's tensors."""
    tree = _unflat({k.split("/", 1)[1]: v for k, v in reference.items()
                    if k.startswith(f"params-{int(tie)}/")})
    return tree, params_from_reference(tree, device="cpu")


@pytest.fixture(scope="module")
def one_process(reference):
    """Per cell, the one-process port on the same weights and inputs:
    forward, prefill, the 8 serve steps' logits and tokens from the whole
    padded cache, and that cache after them."""
    out = {}
    for cell, (_, model, tie) in CELLS.items():
        cfg = _cfg(tie)
        _, params = _weights(reference, tie)
        toks, kv, first = _inputs(tie)
        pad = kv_head_pad(cfg, model)
        with torch.inference_mode():
            tokens = torch.from_numpy(toks)
            fwd = tfm.forward(cfg, params, tokens=tokens)[0]
            pre = tfm.prefill(cfg, params, tokens=tokens)
            cache = tfm.DecodeCache(pos=P0, layers={"dense": tuple(
                torch.from_numpy(np.repeat(t, pad, axis=2)) for t in kv)})
            step = make_serve_step(cfg)
            tok = torch.from_numpy(first)
            steps, tokens_out = [], []
            for _ in range(STEPS):
                tok, lg, cache = step(params, tok, cache)
                steps.append(lg)
                tokens_out.append(tok)
        out[cell] = {"forward": fwd, "prefill": pre,
                     "steps": torch.stack(steps),
                     "tokens": torch.stack(tokens_out),
                     "cache": cache.layers["dense"]}
    return out


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ----------------------------------------------------------- the logits

@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_logits_match_reference(worlds, reference, cell):
    for run in worlds[cell]:
        rows = slice(run["coords"]["data"] * B // CELLS[cell][0],
                     (run["coords"]["data"] + 1) * B // CELLS[cell][0])
        want = reference[f"{cell}/forward"][rows]
        assert run["forward"].shape == want.shape
        assert _err(run["forward"], want) <= TOL_REF, run["coords"]
        assert _err(run["prefill"], want[:, -1]) <= TOL_REF, run["coords"]
        steps = reference[f"{cell}/steps"][:, rows]
        assert _err(run["steps"], steps) <= TOL_REF, run["coords"]
        np.testing.assert_array_equal(run["tokens"].numpy(),
                                      reference[f"{cell}/tokens"][:, rows])


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_logits_match_one_process(worlds, one_process, cell):
    want = one_process[cell]
    for run in worlds[cell]:
        rows = slice(run["coords"]["data"] * B // CELLS[cell][0],
                     (run["coords"]["data"] + 1) * B // CELLS[cell][0])
        for key in ("forward", "prefill"):
            assert _err(run[key], want[key][rows]) <= TOL_PORT, (key, run[
                "coords"])
        assert _err(run["steps"], want["steps"][:, rows]) <= TOL_PORT
        assert torch.equal(run["tokens"], want["tokens"][:, rows])


# ------------------------------------------------------------ the shards

REPLICATED = {"ln1", "ln2", "final_norm", "q_norm", "k_norm"}
COLUMNS = {"wq", "w_gate", "w_in", "lm_head"}
ROWS = {"wo", "w_out"}


def _expected(cfg, name, leaf, c, model):
    """Rank ``c``'s (its model coordinate) slice of the whole leaf
    ``name``, by its role in the tensor-parallel layer."""
    last = name.split("/")[-1]
    hd, pad = cfg.head_dim, kv_head_pad(cfg, model)

    def split(dim):
        n = leaf.shape[dim] // model
        idx = [slice(None)] * leaf.ndim
        idx[dim] = slice(c * n, (c + 1) * n)
        return leaf[tuple(idx)]

    if last in REPLICATED:
        return leaf
    if last == "embed":
        return split(0)
    if last in COLUMNS:
        return split(-1)
    if last in ROWS:
        return split(-2)
    assert last in ("wk", "wv"), name
    if pad == 1:
        return split(-1)
    head = c * (cfg.n_kv_heads * pad // model) // pad  # the KV head it reads
    return leaf[..., head * hd:(head + 1) * hd]


@pytest.mark.parametrize("cell", list(CELLS))
def test_weight_shards_are_slices_of_the_whole(worlds, reference, cell):
    """Drawn as shards: the slices of the one-process ``init_params``;
    carried from ``repro``: the slices of its numpy leaves; bit for
    bit."""
    _, model, tie = CELLS[cell]
    cfg = _cfg(tie)
    whole = dict(_flat(tfm.init_params(cfg, seed=0, device="cpu")))
    tree, _ = _weights(reference, tie)
    carried = dict(_flat(tree))
    for run in worlds[cell]:
        c = run["coords"]["model"]
        drawn, params = dict(_flat(run["drawn"])), dict(_flat(run["params"]))
        assert sorted(drawn) == sorted(whole) == sorted(params)
        for name, leaf in whole.items():
            assert torch.equal(drawn[name],
                               _expected(cfg, name, leaf, c, model)), name
            np.testing.assert_array_equal(
                params[name].numpy(),
                _expected(cfg, name, carried[name], c, model), err_msg=name)


def test_half_head_rank_holds_the_kv_head_of_its_cache_shard(worlds):
    """(1, 4): ``kv_head_pad`` 2, each rank's wk is one whole KV head (32
    columns, where ``param_specs`` would give 16), its cache one head."""
    cfg = _cfg(False)
    assert kv_head_pad(cfg, 4) == 2
    for run in worlds["tp4"]:
        assert run["params"]["dense"]["attn"]["wk"].shape[-1] == cfg.head_dim
        assert run["params"]["dense"]["attn"]["wq"].shape[-1] == cfg.head_dim
        assert run["cache"][0].shape[2] == 1


@pytest.mark.parametrize("cell", list(CELLS))
def test_cache_shards_after_the_steps_are_slices(worlds, one_process,
                                                 reference, cell):
    """Each rank's cache after the 8 steps: its rows and heads of the
    one-process cache, bit for bit at the positions no step wrote, within
    1e-5 at the 8 it wrote; and within 1e-4 of ``repro``'s."""
    data, model, _ = CELLS[cell]
    written = slice(P0, P0 + STEPS)
    for run in worlds[cell]:
        d, c = run["coords"]["data"], run["coords"]["model"]
        assert run["pos"] == P0 + STEPS
        for i, name in enumerate("kv"):
            got = run["cache"][i]
            n = got.shape[2]
            idx = (slice(None), slice(d * B // data, (d + 1) * B // data),
                   slice(c * n, (c + 1) * n))
            want = one_process[cell]["cache"][i][idx]
            assert got.shape == want.shape
            keep = torch.ones(MAX_SEQ, dtype=torch.bool)
            keep[written] = False
            assert torch.equal(got[:, :, :, keep], want[:, :, :, keep])
            assert _err(got[:, :, :, written], want[:, :, :, written]) \
                <= TOL_PORT
            assert _err(got, reference[f"{cell}/{name}"][idx]) <= TOL_REF


@pytest.mark.parametrize("cell", list(CELLS))
def test_bytes_per_kind_equal_their_formula(worlds, cell):
    """To each other rank of its model group, a rank sends the
    embedding's and each layer's two f32 all-reduces of its [rows, seq,
    d_model] and its f32 logits [rows, positions, V / model] (positions:
    S for ``forward``, 1 for ``prefill`` and a step); nothing to any other
    rank, nothing else."""
    data, model, tie = CELLS[cell]
    cfg = _cfg(tie)
    rows = B // data
    runs = worlds[cell]
    for run in runs:
        peers = [r for r, other in enumerate(runs)
                 if other["coords"]["data"] == run["coords"]["data"]
                 and other["coords"] != run["coords"]]
        for key, seq, positions, times in (("forward_bytes", S, S, 1),
                                           ("prefill_bytes", S, 1, 1),
                                           ("step_bytes", 1, 1, STEPS)):
            reduce = times * (2 * cfg.n_layers + 1) * rows * seq \
                * cfg.d_model * 4
            gather = times * rows * positions * cfg.vocab_size // model * 4
            want = {"p2p": [0] * len(runs), "scalar": [0] * len(runs),
                    "reduce": [reduce if r in peers else 0
                               for r in range(len(runs))],
                    "gather": [gather if r in peers else 0
                               for r in range(len(runs))]}
            assert run[key] == want, (cell, key, run["coords"])


# ---------------------------------------------------- what stays as it was

def test_sharded_draw_is_the_whole_draw_off_ranks():
    """``init_params`` with ``shard`` giving every leaf whole draws the
    same values, and on a logical mesh the collectives are the identity:
    forward bit for bit the one without a mesh."""
    cfg = _cfg(False)
    a = tfm.init_params(cfg, seed=3, device="cpu")
    b = tfm.init_params(cfg, seed=3, device="cpu",
                        shard=lambda path, shape: None)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_flat(a),
                                                           _flat(b)))
    toks = torch.from_numpy(_inputs(False)[0])
    want = tfm.forward(cfg, a, tokens=toks)[0]
    mesh = make_dev_mesh(4, device="cpu")
    with launch_mesh(mesh, global_batch=B):
        assert tp.tp_mesh() is None
        assert torch.equal(tfm.forward(cfg, a, tokens=toks)[0], want)


def _mamba(n_groups, **over):
    """The reduced mamba2-1.3b (8 SSM heads) with ``n_groups`` SSM groups
    and ``over`` replaced."""
    cfg = reduced(get_config("mamba2-1.3b"))
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, n_groups=n_groups), **over)


# (arch, model axes at full size): every family, reduced on 2 and 4 ranks
# (the moe family: grok-1-314b's GQA, deepseek-v3-671b's MLA)
FAMILIES = [("yi-6b", (2,)), ("starcoder2-3b", (4,)),
            ("grok-1-314b", (2, 4)), ("deepseek-v3-671b", (2, 4)),
            ("mamba2-1.3b", (2, 4)), ("zamba2-1.2b", (2, 4)),
            ("seamless-m4t-large-v2", (2,))]


@pytest.mark.parametrize("arch,full", FAMILIES)
def test_every_family_passes_a_ranked_model_axis(arch, full):
    """``check_tp`` passes every family on a model axis of ranks, reduced
    on 2 and 4 ranks and at full size on the axes in ``full``."""
    for model in (2, 4):
        tp.check_tp(reduced(get_config(arch)), model)
    for model in full:
        tp.check_tp(get_config(arch), model)
    tp.check_tp(get_config(arch), 1)         # no model axis: nothing to do


@pytest.mark.parametrize("arch,items", [
    ("seamless-m4t-large-v2", [("embed", P(None, "model")),
                               ("lm_head", P("model", None))])])
def test_unported_families_refuse_a_ranked_model_axis(arch, items):
    """Full-size seamless-m4t-large-v2 on 4 ranks, which refused until the
    d_model-sharded embedding and head (A8d5b): its vocabulary of 256 206
    does not divide over 4, so ``check_tp`` passes it with the embedding
    and the head split on d_model, as ``param_specs`` splits them."""
    cfg = get_config(arch)
    tp.check_tp(cfg, 4)
    assert not tp.vocab_sharded(cfg, 4) and tp.vocab_sharded(cfg, 2)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 4},
                                 coords={"data": 0, "model": 1})
    specs = tp.param_shard_specs(cfg, mesh)
    for leaf, spec in items:
        assert specs[leaf] == spec, (leaf, specs[leaf])


@pytest.mark.parametrize("make,model,message", [
    (lambda: reduced(get_config("yi-6b"), n_heads=6, n_kv_heads=2), 4,
     "6 query heads"),
    # 12 SSM heads in 3 groups: the axis neither divides the groups nor is
    # divided by them
    (lambda: _mamba(3, d_model=192, vocab_size=516), 2, "SSM groups"),
    (lambda: _mamba(4), 16, "8 SSM heads"),
    # neither the vocabulary nor d_model divides: no layout of the head
    (lambda: reduced(get_config("yi-6b"), d_model=130, d_head=32,
                     vocab_size=510), 4,
     "130 columns of d_model .* vocabulary of 510 does not divide")],
    ids=["query-heads", "ssm-groups", "ssm-heads", "vocabulary"])
def test_a_model_axis_that_does_not_divide_refuses(make, model, message):
    with pytest.raises(ValueError, match=message):
        tp.check_tp(make(), model)


@pytest.mark.parametrize("make,model", [
    (lambda: _cfg(False), 4), (lambda: get_config("starcoder2-3b"), 4),
    (lambda: get_config("yi-6b"), 2),
    (lambda: _mamba(3, d_model=192, vocab_size=516), 3),
    (lambda: _mamba(3, d_model=192, vocab_size=516), 6),
    (lambda: _mamba(4), 4), (lambda: _mamba(2), 4)],
    ids=["yi-reduced-4", "starcoder2-4", "yi-2", "ssm-groups-3",
         "ssm-groups-6", "ssm-groups-4", "ssm-one-group-a-rank"])
def test_a_model_axis_that_divides_passes(make, model):
    """The axis divides the query heads, the SSM heads and the vocabulary,
    and divides the SSM groups or is divided by them."""
    tp.check_tp(make(), model)


# ----------------------------------------------------------- launcher

def _serve(*args):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--reduced", "--device", "cpu", *args],
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO, env=env)


def test_serve_launcher_on_ranks():
    proc = _serve("--arch", "yi-6b", "--host-devices", "2", "--ranks",
                  "--batch", "4", "--tokens", "6")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == ("device: cpu, arch=yi-6b, mesh: {'data': 1, "
                        "'model': 2} on 2 rank processes, kv_head_pad 1")
    assert lines[1].startswith("decoded 6 x batch 4: ") and len(lines) == 2
    sample = ast.literal_eval(lines[1].split("sample ")[1])
    assert len(sample) == 6 and all(0 <= t < 512 for t in sample)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_serve_launcher_serves_every_family_on_ranks(arch):
    """The launcher decodes the ssm, hybrid and encdec families on 2 rank
    processes."""
    proc = _serve("--arch", arch, "--host-devices", "2", "--ranks",
                  "--batch", "2", "--tokens", "3")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == (f"device: cpu, arch={arch}, mesh: {{'data': 1, "
                        "'model': 2} on 2 rank processes, kv_head_pad 1")
    assert lines[1].startswith("decoded 3 x batch 2: ") and len(lines) == 2
    sample = ast.literal_eval(lines[1].split("sample ")[1])
    vocab = reduced(get_config(arch)).vocab_size
    assert len(sample) == 3 and all(0 <= t < vocab for t in sample)


@pytest.mark.parametrize("args,message", [
    (("--reduced", "--arch", "yi-6b", "--ranks"), "pass --host-devices N"),
    pytest.param(("--reduced", "--arch", "seamless-m4t-large-v2",
                  "--host-devices", "4", "--ranks", "--batch", "2",
                  "--tokens", "3"), None, id="args1-A8d5b")])
def test_serve_launcher_refuses_on_ranks(args, message):
    """The launcher refuses, before any rank starts, what a model axis on
    ranks does not run: ``--ranks`` without a mesh. seamless-m4t-large-v2
    on 4 ranks, which it refused until the d_model-sharded embedding and
    head (A8d5b), now serves (reduced here: the full model's f32 weights
    are 8.1 GB)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         *args], capture_output=True, text=True, timeout=600, cwd=REPO,
        env=env)
    if message is None:
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines = proc.stdout.splitlines()
        assert lines[0] == ("device: cpu, arch=seamless-m4t-large-v2, mesh: "
                            "{'data': 1, 'model': 4} on 4 rank processes, "
                            "kv_head_pad 1")
        assert lines[1].startswith("decoded 3 x batch 2: ")
        return
    assert proc.returncode != 0 and message in proc.stderr, proc.stderr
    assert "Traceback" not in proc.stderr


if __name__ == "__main__":
    _write_reference(sys.argv[1])
