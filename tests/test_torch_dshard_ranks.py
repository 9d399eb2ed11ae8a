"""The d_model-sharded embedding and head on a model axis of rank
processes, on the CPU (``dist.tensor_parallel``: ``embed_lookup``,
``head_logits``, ``gather_logits``): where the axis does not divide the
vocabulary, ``param_specs`` splits ``embed`` [V, d] and ``lm_head`` [d, V]
on d_model, and so does each rank.

The reduced seamless-m4t-large-v2 (2 encoder and 2 decoder layers, d_model
128, its own ``lm_head``) and the reduced mamba2-1.3b (2 Mamba-2 layers,
its head tied to ``embed``), f32 compute, at a vocabulary of 510 on a (1,
4) mesh of ranks and of 511 on a (2, 2) one: neither divides over its model
axis (510 does over 2).

- ``forward`` logits [B, S, V], ``prefill``, and 4 greedy serve steps from
  a cache of seeded contents against ``repro``'s ``forward`` and
  ``decode_step`` jitted on 4 forced host devices with its params and
  cache placed by ``param_specs``/``cache_specs`` on an Auto-axis
  ``jax.sharding.Mesh`` (an ``.npz`` from this file's script mode):
  max|port - repro| / max|repro| <= 1e-4, the greedy tokens equal;
- the same against the one-process port on the same inputs: <= 1e-5,
  tokens equal, every rank of a model group's logits equal;
- the lookup: each rank's ``embed_lookup`` of the prompt bit for bit the
  one-process ``embed[tokens]``; each rank's ``embed`` and ``lm_head``,
  drawn as shards, bit for bit the d_model columns (rows) of the whole
  draw;
- the bytes each rank sends each peer, by kind, in ``forward``,
  ``prefill`` and the steps equal their formula: the embedding's d-slices
  gathered ([T, d / model]), the head's f32 partials all-reduced ([rows,
  positions, V], a prefill's last position only) beside the layers' sums.

The rank functions live here (a spawned child imports this module, which
imports nothing of JAX at its top). One world of 4 ranks runs every cell.
"""

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
from repro_torch.dist.sharding import P
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import (params_from_reference,
                                        shard_params_from_reference)
from repro_torch.models.mamba2 import Mamba2State
from repro_torch.serve.decode import make_serve_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# batch, prompt, cache positions, positions filled, greedy steps, encoder
# frames
B, S, MAX_SEQ, P0, STEPS, FRAMES = 4, 24, 24, 20, 4, 12
MAMBA, SEAMLESS = "mamba2-1.3b", "seamless-m4t-large-v2"
# name -> (arch, data, model, vocabulary)
CELLS = {"seamless-tp4": (SEAMLESS, 1, 4, 510),
         "seamless-dp2-tp2": (SEAMLESS, 2, 2, 511),
         "mamba2-tied-tp4": (MAMBA, 1, 4, 510),
         "mamba2-tied-dp2-tp2": (MAMBA, 2, 2, 511)}
TOL_REF, TOL_PORT = 1e-4, 1e-5


def _over(base, vocab):
    """``base`` (either package's ``reduced(get_config(arch))``) in f32
    compute at a vocabulary of ``vocab``."""
    return dataclasses.replace(base, compute_dtype="float32",
                               vocab_size=vocab)


def _cfg(cell):
    arch, _, _, vocab = CELLS[cell]
    return _over(reduced(get_config(arch)), vocab)


def _inputs(cfg):
    """The prompt [B, S], the encoder's frame embeddings [B, FRAMES, d]
    (encdec), the cache's seeded leaves by segment (ssm: conv [L, B,
    d_conv-1, conv_dim] and the SSM state [L, B, nh, N, P] x 0.1; encdec:
    the self cache (k, v) [L, B, Hkv, MAX_SEQ, hd] at positions < P0 and
    the cross cache (k, v) [L, B, Hkv, FRAMES, hd]) and the first decode
    tokens [B], from numpy with a seed."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    enc = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)
    cache = {}
    kv = (cfg.n_layers, B, cfg.n_kv_heads)
    if cfg.ssm is not None:
        ssm = cfg.ssm
        di, nh = ssm.d_inner(cfg.d_model), ssm.n_heads(cfg.d_model)
        conv = (cfg.n_layers, B, ssm.d_conv - 1,
                di + 2 * ssm.n_groups * ssm.d_state)
        state = (cfg.n_layers, B, nh, ssm.d_state, ssm.head_dim)
        cache["ssm"] = (rng.standard_normal(conv).astype(np.float32),
                        0.1 * rng.standard_normal(state).astype(np.float32))
    else:
        shape = (*kv, MAX_SEQ, cfg.head_dim)
        self_kv = []
        for _ in range(2):
            a = np.zeros(shape, np.float32)
            a[..., :P0, :] = rng.standard_normal((*kv, P0, cfg.head_dim))
            self_kv.append(a)
        cache["cross_self"] = tuple(self_kv)
        cache["enc_out"] = tuple(rng.standard_normal(
            (*kv, FRAMES, cfg.head_dim)).astype(np.float32)
            for _ in range(2))
    return toks, enc, cache, rng.integers(0, cfg.vocab_size, (B,))


def _port_cache(cache, device="cpu"):
    """The seeded numpy cache as the port's ``DecodeCache`` at P0."""
    segs = {}
    for key, leaves in cache.items():
        ts = tuple(torch.from_numpy(a).to(device) for a in leaves)
        segs[key] = Mamba2State(*ts) if key == "ssm" else ts
    return tfm.DecodeCache(pos=P0, layers=segs)


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


def _rows(data, d):
    n = B // data
    return slice(d * n, (d + 1) * n)


def _prompt(cfg, toks, enc, rows, device="cpu"):
    kw = {"tokens": torch.from_numpy(toks[rows]).to(device)}
    if cfg.family == "encdec":
        kw["enc_embeds"] = torch.from_numpy(enc[rows]).to(device)
    return kw


def _serve(cfg, params, first, cache):
    """STEPS greedy serve steps: (their logits, their tokens)."""
    step = make_serve_step(cfg)
    tok, logits, tokens = first, [], []
    for _ in range(STEPS):
        tok, lg, cache = step(params, tok, cache)
        logits.append(lg)
        tokens.append(tok)
    return torch.stack(logits), torch.stack(tokens)


def _sent(net):
    return {k: list(v) for k, v in net.bytes.items()}


# ------------------------------------------------------ rank functions

def dshard_cell(rank, world, ref_path, cell, *, device):
    """One cell on this rank: its weights carried from ``repro``'s and
    drawn as shards, then under ``launch_mesh`` its rows' lookup,
    ``forward`` and ``prefill`` logits and STEPS greedy serve steps from
    its shard of the seeded cache, with the bytes each sent by kind."""
    _, data, model, _ = CELLS[cell]
    cfg = _cfg(cell)
    with np.load(ref_path) as f:
        tree = _unflat({k.split("/", 1)[1]: f[k] for k in f.files
                        if k.startswith(f"params-{cell}/")})
    mesh = Mesh((data, model), ("data", "model"), device,
                group=dist.group.WORLD)
    params = shard_params_from_reference(cfg, tree, mesh, device)
    drawn = tp.init_shard_params(cfg, mesh, seed=0, device=device)
    toks, enc, cache, first = _inputs(cfg)
    rows = _rows(data, mesh.coords["data"])
    net = mesh.transport
    out = {"coords": mesh.coords,
           "drawn": {k: drawn[k] for k in ("embed", "lm_head") if k in drawn}}
    with torch.inference_mode(), launch_mesh(mesh, global_batch=B):
        prompt = _prompt(cfg, toks, enc, rows, device)
        out["lookup"] = tp.embed_lookup(cfg, params["embed"],
                                        prompt["tokens"])
        net.reset()
        out["forward"] = tfm.forward(cfg, params, **prompt)[0]
        out["forward_bytes"] = _sent(net)
        net.reset()
        out["prefill"] = tfm.prefill(cfg, params, **prompt)
        out["prefill_bytes"] = _sent(net)
        net.reset()
        out["steps"], out["tokens"] = _serve(
            cfg, params, torch.from_numpy(first[rows]).to(device),
            tp.shard_cache(cfg, _port_cache(cache, device), mesh))
        out["step_bytes"] = _sent(net)
    return out


# ------------------------------------------------------------- worlds

def _write_reference(path):
    """``repro``'s parameters (seed 0) per cell and its jitted ``forward``
    logits and STEPS greedy ``decode_step``s' logits and tokens, with
    params and cache placed by its specs on an Auto-axis mesh of the
    cell's shape over the 4 host devices (this file's script mode)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jx_base
    from repro.configs.registry import get_config as jx_get_config
    from repro.dist import ctx as jx_ctx
    from repro.dist import sharding as jx_sh
    from repro.models import mamba2 as jx_mamba2
    from repro.models import transformer as jx_tfm

    out = {}
    for cell, (arch, data, model, vocab) in CELLS.items():
        jcfg = _over(jx_base.reduced(jx_get_config(arch)), vocab)
        jp = jx_tfm.init_params(jcfg, jax.random.key(0))
        for name, a in _flat(jax.tree.map(np.asarray, jp)):
            out[f"params-{cell}/{name}"] = a
        toks, enc, cache, first = _inputs(jcfg)
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:data * model]).reshape(data, model),
            ("data", "model"))
        axes = jx_sh.batch_axis(mesh, B)
        jx_ctx.set_batch_axes(axes)
        kw = {"tokens": jnp.asarray(toks)}
        if jcfg.family == "encdec":
            kw["enc_embeds"] = jnp.asarray(enc)
        try:
            with jx_ctx.use_mesh(mesh):
                p_specs = jx_sh.sanitize_specs(
                    jx_sh.param_specs(jcfg, model_axis=model),
                    jx_tfm.abstract_params(jcfg), mesh)
                assert p_specs["embed"] == jax.sharding.PartitionSpec(
                    None, "model"), p_specs["embed"]
                params = jax.device_put(jp, jx_sh.named_shardings(mesh,
                                                                  p_specs))
                logits = jax.jit(lambda p, kw: jx_tfm.forward(
                    jcfg, p, **kw)[0])(params, kw)
                layers_ = {k: (jx_mamba2.Mamba2State(*map(jnp.asarray, v))
                               if k == "ssm" else tuple(map(jnp.asarray, v)))
                           for k, v in cache.items()}
                jcache = jx_tfm.DecodeCache(pos=jnp.asarray(P0, jnp.int32),
                                            layers=layers_)
                shapes = jax.eval_shape(lambda: jcache)
                c_specs = jx_sh.sanitize_specs(jx_sh.cache_specs(
                    jcfg, shapes, axes, model_axis=model), shapes, mesh)
                jcache = jax.tree.map(
                    lambda x, s: jax.device_put(x, jax.NamedSharding(mesh,
                                                                     s)),
                    jcache, c_specs, is_leaf=lambda x: hasattr(x, "shape"))
                step = jax.jit(lambda p, t, c: jx_tfm.decode_step(jcfg, p, t,
                                                                  c))
                tok = jnp.asarray(first, jnp.int32)
                steps, tokens = [], []
                for _ in range(STEPS):
                    lg, jcache = step(params, tok, jcache)
                    tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
                    steps.append(np.asarray(lg))
                    tokens.append(np.asarray(tok))
        finally:
            jx_ctx.set_batch_axes(None)
        out[f"{cell}/forward"] = np.asarray(logits)
        out[f"{cell}/steps"] = np.stack(steps)
        out[f"{cell}/tokens"] = np.stack(tokens)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s outputs, from this file's script mode on 4 forced host
    devices; ``path`` is the ``.npz`` the ranks read the weights from."""
    path = tmp_path_factory.mktemp("jax_dshard_ranks") / "outputs.npz"
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
def worlds(reference):
    """One world of 4 ranks, its cells run in turn: cell -> the ranks'
    results in rank order."""
    runs = ranks.spawn_ranks(ranks.run_jobs, 4, [
        (dshard_cell, (reference["path"], c), {}) for c in CELLS],
        device="cpu", timeout=600)
    return {c: [r[i] for r in runs] for i, c in enumerate(CELLS)}


@pytest.fixture(scope="module")
def one_process(reference):
    """Per cell, the one-process port on the same weights and inputs: the
    lookup of the prompt, forward, prefill and the STEPS serve steps'
    logits and tokens from the whole seeded cache."""
    out = {}
    for cell in CELLS:
        cfg = _cfg(cell)
        params = params_from_reference(_unflat(
            {k.split("/", 1)[1]: v for k, v in reference.items()
             if k.startswith(f"params-{cell}/")}), device="cpu")
        toks, enc, cache, first = _inputs(cfg)
        with torch.inference_mode():
            prompt = _prompt(cfg, toks, enc, slice(None))
            lookup = params["embed"][prompt["tokens"]]
            fwd = tfm.forward(cfg, params, **prompt)[0]
            pre = tfm.prefill(cfg, params, **prompt)
            steps, tokens = _serve(cfg, params, torch.from_numpy(first),
                                   _port_cache(cache))
        out[cell] = {"lookup": lookup, "forward": fwd, "prefill": pre,
                     "steps": steps, "tokens": tokens}
    return out


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _own_rows(cell, run):
    return _rows(CELLS[cell][1], run["coords"]["data"])


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("cell", list(CELLS))
def test_the_layout_is_param_specs_d_model_split(cell):
    """The axis does not divide the vocabulary: ``embed`` is split on its
    columns and ``lm_head`` on its rows, as ``param_specs`` has them, and
    ``check_tp`` passes."""
    _, data, model, _ = CELLS[cell]
    cfg = _cfg(cell)
    tp.check_tp(cfg, model)
    assert not tp.vocab_sharded(cfg, model)
    mesh = types.SimpleNamespace(shape={"data": data, "model": model},
                                 coords={"data": 0, "model": model - 1})
    specs = tp.param_shard_specs(cfg, mesh)
    assert specs["embed"] == P(None, "model")
    assert ("lm_head" in specs) == (not cfg.tie_embeddings)
    if not cfg.tie_embeddings:
        assert specs["lm_head"] == P("model", None)
    boxes = tp.shard_boxes(cfg, tfm.abstract_params(cfg), mesh)
    d = cfg.d_model // model
    assert boxes["embed"][1] == slice((model - 1) * d, model * d)


@pytest.mark.parametrize("cell", list(CELLS))
def test_drawn_shards_are_the_d_model_columns(worlds, cell):
    """Each rank's ``embed`` (and ``lm_head``), drawn as shards, bit for
    bit its d_model columns (rows) of the one-process draw."""
    _, _, model, _ = CELLS[cell]
    cfg = _cfg(cell)
    whole = tfm.init_params(cfg, seed=0, device="cpu")
    d = cfg.d_model // model
    for run in worlds[cell]:
        c = run["coords"]["model"]
        cols = slice(c * d, (c + 1) * d)
        assert torch.equal(run["drawn"]["embed"], whole["embed"][:, cols])
        if not cfg.tie_embeddings:
            assert torch.equal(run["drawn"]["lm_head"],
                               whole["lm_head"][cols])


@pytest.mark.parametrize("cell", list(CELLS))
def test_lookup_is_bit_for_bit(worlds, one_process, cell):
    for run in worlds[cell]:
        want = one_process[cell]["lookup"][_own_rows(cell, run)]
        assert run["lookup"].shape == want.shape
        assert torch.equal(run["lookup"], want), run["coords"]


# ----------------------------------------------------------- the logits

@pytest.mark.parametrize("cell", list(CELLS))
def test_ranked_logits_match_reference(worlds, reference, cell):
    for run in worlds[cell]:
        rows = _own_rows(cell, run)
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
    runs = worlds[cell]
    for run in runs:
        rows = _own_rows(cell, run)
        for key in ("forward", "prefill"):
            assert _err(run[key], want[key][rows]) <= TOL_PORT, (key, run[
                "coords"])
        assert _err(run["steps"], want["steps"][:, rows]) <= TOL_PORT
        assert torch.equal(run["tokens"], want["tokens"][:, rows])
        for other in runs:      # the model group's summed logits agree
            if other["coords"]["data"] == run["coords"]["data"]:
                for key in ("forward", "prefill", "steps"):
                    assert torch.equal(run[key], other[key]), key


# ------------------------------------------------------------ the bytes

def _layer_reduce(cfg, rows, seq, frames):
    """The f32 bytes of the layers' all-reduces with each peer in a forward
    of ``rows`` x ``seq`` tokens (``frames`` encoder frames a row): each
    attention ``wo`` (the cross's too) and dense FFN ``w_out`` at [T,
    d_model], the encoder's at [rows·frames, d_model]; each Mamba-2
    ``w_out`` and its norm's [T, 1] sum of squares. The embedding adds
    none: its d-slices are gathered."""
    t, d = rows * seq, cfg.d_model
    if cfg.family == "encdec":
        return 4 * d * (3 * cfg.n_layers * t
                        + 2 * cfg.encoder_layers * rows * frames)
    return 4 * t * cfg.n_layers * (d + 1)


@pytest.mark.parametrize("cell", list(CELLS))
def test_bytes_per_kind_equal_their_formula(worlds, cell):
    """To each other rank of its model group a rank sends the layers'
    all-reduces, the head's f32 partials [rows, positions, V] (positions:
    S for ``forward``, 1 for ``prefill`` and a step) in one all-reduce,
    and its d-slices of the tokens' embeddings [rows, seq, d_model /
    model] in f32 (``gather``); nothing to any other rank, nothing
    else."""
    _, data, model, _ = CELLS[cell]
    cfg = _cfg(cell)
    rows = B // data
    runs = worlds[cell]
    for run in runs:
        peers = [r for r, other in enumerate(runs)
                 if other["coords"]["data"] == run["coords"]["data"]
                 and other["coords"] != run["coords"]]
        for key, seq, frames, positions, times in (
                ("forward_bytes", S, FRAMES, S, 1),
                ("prefill_bytes", S, FRAMES, 1, 1),
                ("step_bytes", 1, 0, 1, STEPS)):
            reduce = times * (_layer_reduce(cfg, rows, seq, frames)
                              + 4 * rows * positions * cfg.vocab_size)
            gather = times * rows * seq * cfg.d_model // model * 4
            want = {"p2p": [0] * len(runs), "scalar": [0] * len(runs),
                    "reduce": [reduce if r in peers else 0
                               for r in range(len(runs))],
                    "gather": [gather if r in peers else 0
                               for r in range(len(runs))]}
            assert run[key] == want, (cell, key, run["coords"])


if __name__ == "__main__":
    _write_reference(sys.argv[1])
