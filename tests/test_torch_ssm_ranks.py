"""The ssm, hybrid and encdec families on a model axis of rank processes,
on the CPU: the ("data", "model") mesh laid on spawned processes joined
into a gloo group (``launch.mesh.Mesh(..., group=)``,
``dist.tensor_parallel``), with Mamba-2's heads split head-aligned
(``mamba2.head_columns``), its gated norm summed over the group
and the attention heads, rings and cross caches per rank.

The reduced mamba2-1.3b (2 Mamba-2 layers, 8 SSM heads of 32, d_state
16), zamba2-1.2b (4 Mamba-2 layers, the shared block after every 2 with
4 query and 4 KV heads and ``sliding_window`` 16 in both packages, as
``tests/test_torch_hybrid.py`` has it, so that the prompt passes the
window and the ring wraps) and seamless-m4t-large-v2 (2 encoder and 2
decoder layers, 4 heads), f32 compute. Cells: (1, 2), (2, 2) and (1, 4)
meshes of ranks for each; mamba2 with 2 groups on (1, 4) (a rank holds the
one group its heads read) and with 4 groups on (1, 2) (a rank holds 2).

- ``forward`` logits [B, S, V], ``prefill``, and 4 greedy serve steps from
  a cache of seeded contents (the SSM and conv states, every ring slot,
  the self cache's first P0 positions and the whole cross cache) against
  ``repro``'s ``forward`` and ``decode_step`` jitted on 4 forced host
  devices with its params and cache placed by
  ``param_specs``/``cache_specs`` on an Auto-axis ``jax.sharding.Mesh``
  (an ``.npz`` from this file's script mode): max|port - repro| /
  max|repro| <= 1e-4, the greedy tokens equal;
- the same against the one-process port on the same inputs (the sums
  over ranks in another order only): <= 1e-5, tokens equal, every rank's
  gathered logits equal;
- each rank's cache after the steps: the one-process cache's rows and
  heads (the conv state's x, B and C channels of its heads and groups),
  within 1e-5;
- each rank's weights, drawn as shards (``init_shard_params``) and carried
  from ``repro``'s numpy parameters: bit for bit the columns of the whole
  trees, taken here by role from the heads and the groups they read (and
  in bf16 drawn in pieces, ``layers.DRAW`` cut, for every rank of each
  group case);
- the bytes each rank sends each peer, by kind, in ``forward``,
  ``prefill`` and the steps equal their formula;
- with no ranked model axis the Mamba-2 sizes read from the weights are
  the config's.

The rank functions live here (a spawned child imports this module, which
imports nothing of JAX at its top). Each world is spawned once for the
module: one of 2 ranks, one of 4.
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
from repro_torch.dist.sharding import kv_head_pad
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import (params_from_reference,
                                        shard_params_from_reference)
from repro_torch.models.mamba2 import (Mamba2State, head_columns,
                                       local_sizes)
from repro_torch.serve.decode import make_serve_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# batch, prompt, cache positions, positions filled, greedy steps, encoder
# frames, the hybrid's window
B, S, MAX_SEQ, P0, STEPS, FRAMES, WINDOW = 4, 24, 24, 20, 4, 12, 16
MAMBA, ZAMBA, SEAMLESS = "mamba2-1.3b", "zamba2-1.2b", "seamless-m4t-large-v2"
# name -> (arch, data, model, SSM groups (0: the config's))
CELLS = {"mamba2-tp2": (MAMBA, 1, 2, 0),
         "mamba2-dp2-tp2": (MAMBA, 2, 2, 0),
         "mamba2-tp4": (MAMBA, 1, 4, 0),
         "mamba2-g2-tp4": (MAMBA, 1, 4, 2),
         "mamba2-g4-tp2": (MAMBA, 1, 2, 4),
         "zamba2-tp2": (ZAMBA, 1, 2, 0),
         "zamba2-dp2-tp2": (ZAMBA, 2, 2, 0),
         "zamba2-tp4": (ZAMBA, 1, 4, 0),
         "seamless-tp2": (SEAMLESS, 1, 2, 0),
         "seamless-dp2-tp2": (SEAMLESS, 2, 2, 0),
         "seamless-tp4": (SEAMLESS, 1, 4, 0)}
WORLDS = {2: [c for c, v in CELLS.items() if v[1] * v[2] == 2],
          4: [c for c, v in CELLS.items() if v[1] * v[2] == 4]}
TOL_REF, TOL_PORT = 1e-4, 1e-5


def _over(arch, base, groups):
    """The reduced config of ``arch`` from ``base`` (either package's
    ``reduced(get_config(arch))``), f32 compute, the hybrid's window 16,
    ``groups`` SSM groups when nonzero."""
    cfg = dataclasses.replace(base, compute_dtype="float32")
    if arch == ZAMBA:
        cfg = dataclasses.replace(cfg, sliding_window=WINDOW)
    if groups:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, n_groups=groups))
    return cfg


def _cfg(cell):
    arch, _, _, groups = CELLS[cell]
    return _over(arch, reduced(get_config(arch)), groups)


def _weights_key(cell):
    """Cells share ``repro``'s weights by (arch, groups)."""
    arch, _, _, groups = CELLS[cell]
    return f"{arch}-{groups}"


def _inputs(cfg):
    """The prompt [B, S], the encoder's frame embeddings [B, FRAMES, d]
    (encdec), the cache's seeded leaves by segment (ssm: conv [L, B,
    d_conv-1, conv_dim] and the SSM state [L, B, nh, N, P] x 0.1; hybrid:
    those and every slot of the ring (k, v) [sites, B, Hkv, WINDOW, hd];
    encdec: the self cache (k, v) [L, B, Hkv, MAX_SEQ, hd] at positions <
    P0 and the cross cache (k, v) [L, B, Hkv, FRAMES, hd]) and the first
    decode tokens [B], from numpy with a seed."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    enc = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)
    cache = {}
    kv = (B, cfg.n_kv_heads)
    if cfg.ssm is not None:
        ssm = cfg.ssm
        di, nh = ssm.d_inner(cfg.d_model), ssm.n_heads(cfg.d_model)
        conv = (cfg.n_layers, B, ssm.d_conv - 1,
                di + 2 * ssm.n_groups * ssm.d_state)
        state = (cfg.n_layers, B, nh, ssm.d_state, ssm.head_dim)
        cache["ssm"] = (rng.standard_normal(conv).astype(np.float32),
                        0.1 * rng.standard_normal(state).astype(np.float32))
    if cfg.family == "hybrid":
        sites = len(tfm._hybrid_segments(cfg)) - 1
        shape = (sites, *kv, WINDOW, cfg.head_dim)
        cache["shared_kv"] = tuple(rng.standard_normal(shape).astype(
            np.float32) for _ in range(2))
    if cfg.family == "encdec":
        shape = (cfg.n_layers, *kv, MAX_SEQ, cfg.head_dim)
        self_kv = []
        for _ in range(2):
            a = np.zeros(shape, np.float32)
            a[..., :P0, :] = rng.standard_normal((*shape[:3], P0,
                                                  cfg.head_dim))
            self_kv.append(a)
        cache["cross_self"] = tuple(self_kv)
        cache["enc_out"] = tuple(rng.standard_normal(
            (cfg.n_layers, *kv, FRAMES, cfg.head_dim)).astype(np.float32)
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
    """The rows of the batch of data coordinate ``d``."""
    n = B // data
    return slice(d * n, (d + 1) * n)


def _sent(net):
    return {k: list(v) for k, v in net.bytes.items()}


def _prompt(cfg, toks, enc, rows, device="cpu"):
    """The prefill's keyword arguments for ``rows`` of the batch."""
    kw = {"tokens": torch.from_numpy(toks[rows]).to(device)}
    if cfg.family == "encdec":
        kw["enc_embeds"] = torch.from_numpy(enc[rows]).to(device)
    return kw


def _serve(cfg, params, first, cache):
    """STEPS greedy serve steps: (logits, tokens, the cache after)."""
    step = make_serve_step(cfg)
    tok, logits, tokens = first, [], []
    for _ in range(STEPS):
        tok, lg, cache = step(params, tok, cache)
        logits.append(lg)
        tokens.append(tok)
    return torch.stack(logits), torch.stack(tokens), cache


def _layers_of(cache) -> dict:
    """A cache's leaves by name (``ssm/conv``, ``shared_kv/0``, ...)."""
    out = {}
    for key, leaves in cache.layers.items():
        names = leaves._fields if key == "ssm" else range(len(leaves))
        for name, t in zip(names, leaves):
            out[f"{key}/{name}"] = t
    return out


# ------------------------------------------------------ rank functions

def ssm_cell(rank, world, ref_path, cell, *, device):
    """One cell on this rank: its weights carried from ``repro``'s and
    drawn as shards, then under ``launch_mesh`` its rows' ``forward`` and
    ``prefill`` logits and STEPS greedy serve steps from its shard of the
    seeded cache, with the bytes each sent by kind, and its cache
    after."""
    _, data, model, _ = CELLS[cell]
    cfg = _cfg(cell)
    key = _weights_key(cell)
    with np.load(ref_path) as f:
        tree = _unflat({k.split("/", 1)[1]: f[k] for k in f.files
                        if k.startswith(f"params-{key}/")})
    mesh = Mesh((data, model), ("data", "model"), device,
                group=dist.group.WORLD)
    params = shard_params_from_reference(cfg, tree, mesh, device)
    drawn = tp.init_shard_params(cfg, mesh, seed=0, device=device)
    toks, enc, cache, first = _inputs(cfg)
    rows = _rows(data, mesh.coords["data"])
    net = mesh.transport
    out = {"coords": mesh.coords, "params": params, "drawn": drawn}
    with torch.inference_mode(), launch_mesh(mesh, global_batch=B):
        prompt = _prompt(cfg, toks, enc, rows, device)
        net.reset()
        out["forward"] = tfm.forward(cfg, params, **prompt)[0]
        out["forward_bytes"] = _sent(net)
        net.reset()
        out["prefill"] = tfm.prefill(cfg, params, **prompt)
        out["prefill_bytes"] = _sent(net)
        net.reset()
        out["steps"], out["tokens"], after = _serve(
            cfg, params, torch.from_numpy(first[rows]).to(device),
            tp.shard_cache(cfg, _port_cache(cache, device), mesh))
        out["step_bytes"] = _sent(net)
    out.update(cache=_layers_of(after), pos=after.pos)
    return out


# ------------------------------------------------------------- worlds

def _write_reference(path):
    """``repro``'s parameters (seed 0) per (arch, groups) and, per cell,
    its jitted ``forward`` logits and STEPS greedy ``decode_step``s'
    logits and tokens, with params and cache placed by its specs on an
    Auto-axis mesh of the cell's shape over the 4 host devices (this
    file's script mode)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jx_base
    from repro.configs.registry import get_config as jx_get_config
    from repro.dist import ctx as jx_ctx
    from repro.dist import sharding as jx_sh
    from repro.models import mamba2 as jx_mamba2
    from repro.models import transformer as jx_tfm

    def jcfg_of(cell):
        arch, _, _, groups = CELLS[cell]
        return _over(arch, jx_base.reduced(jx_get_config(arch)), groups)

    out, weights = {}, {}
    for cell in CELLS:
        key = _weights_key(cell)
        if key not in weights:
            weights[key] = jx_tfm.init_params(jcfg_of(cell),
                                              jax.random.key(0))
            for name, a in _flat(jax.tree.map(np.asarray, weights[key])):
                out[f"params-{key}/{name}"] = a
    for cell, (_, data, model, _) in CELLS.items():
        jcfg = jcfg_of(cell)
        jp = weights[_weights_key(cell)]
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
    path = tmp_path_factory.mktemp("jax_ssm_ranks") / "outputs.npz"
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
    """Each world spawned once, its cells run in turn: cell -> the ranks'
    results in rank order."""
    out = {}
    for world, cells in WORLDS.items():
        runs = ranks.spawn_ranks(ranks.run_jobs, world, [
            (ssm_cell, (reference["path"], c), {}) for c in cells],
            device="cpu", timeout=600)
        for i, c in enumerate(cells):
            out[c] = [r[i] for r in runs]
    return out


def _weights(reference, cell):
    """``repro``'s parameters as numpy arrays and as the port's tensors."""
    key = _weights_key(cell)
    tree = _unflat({k.split("/", 1)[1]: v for k, v in reference.items()
                    if k.startswith(f"params-{key}/")})
    return tree, params_from_reference(tree, device="cpu")


@pytest.fixture(scope="module")
def one_process(reference):
    """Per cell, the one-process port on the same weights and inputs:
    forward, prefill, the STEPS serve steps' logits and tokens from the
    whole seeded cache, and that cache after them."""
    out = {}
    for cell in CELLS:
        cfg = _cfg(cell)
        _, params = _weights(reference, cell)
        toks, enc, cache, first = _inputs(cfg)
        with torch.inference_mode():
            prompt = _prompt(cfg, toks, enc, slice(None))
            fwd = tfm.forward(cfg, params, **prompt)[0]
            pre = tfm.prefill(cfg, params, **prompt)
            steps, tokens, after = _serve(cfg, params,
                                          torch.from_numpy(first),
                                          _port_cache(cache))
        out[cell] = {"forward": fwd, "prefill": pre, "steps": steps,
                     "tokens": tokens, "cache": _layers_of(after)}
    return out


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------- the rank's layout

def _heads(nh, model, c):
    """The heads of model rank ``c``: a contiguous quarter (half, ...)."""
    return np.arange(c * nh // model, (c + 1) * nh // model)


def _columns(cfg, model, c):
    """Model rank ``c``'s columns, by role, derived from its heads: those
    heads' channels of z, x (and the norm), the B and C channels of every
    group one of them reads (head h reads group h // (nh / g)), and their
    dt (and the per-head vectors). Returns (w_in's, the conv's, the
    channels', the heads')."""
    ssm = cfg.ssm
    di, nh = ssm.d_inner(cfg.d_model), ssm.n_heads(cfg.d_model)
    g, n, hd = ssm.n_groups, ssm.d_state, ssm.head_dim
    heads = _heads(nh, model, c)
    chans = (heads[:, None] * hd + np.arange(hd)).ravel()
    groups = np.unique(heads // (nh // g))
    bc = (groups[:, None] * n + np.arange(n)).ravel()
    w_in = np.concatenate([chans, di + chans, 2 * di + bc,
                           2 * di + g * n + bc, 2 * di + 2 * g * n + heads])
    conv = np.concatenate([chans, di + bc, di + g * n + bc])
    return w_in, conv, chans, heads


COLUMNS = {"wq", "wk", "wv", "w_gate", "w_in", "lm_head"}
ROWS = {"wo", "w_out"}
REPLICATED = {"ln", "ln1", "ln2", "ln_cross", "final_norm", "enc_norm"}


def _expected(cfg, name, leaf, c, model):
    """Rank ``c``'s (its model coordinate) part of the whole leaf ``name``,
    by its role in the tensor-parallel layer."""
    keys = name.split("/")
    last = keys[-1]

    def split(dim):
        n = leaf.shape[dim] // model
        idx = [slice(None)] * leaf.ndim
        idx[dim] = slice(c * n, (c + 1) * n)
        return leaf[tuple(idx)]

    if last in REPLICATED:
        return leaf
    if last == "embed":
        return split(0)
    if "mamba" in keys:
        w_in, conv, chans, heads = _columns(cfg, model, c)
        cols = {"w_in": w_in, "conv_w": conv, "conv_b": conv,
                "norm_w": chans}.get(last, heads)
        if last == "w_out":
            return leaf[..., chans, :]
        return leaf[..., cols]
    if last in COLUMNS:
        return split(-1)
    assert last in ROWS, name
    return split(-2)


def _same(a, b) -> bool:
    return np.array_equal(np.asarray(a.float() if torch.is_tensor(a)
                                     else a), np.asarray(
        b.float() if torch.is_tensor(b) else b))


@pytest.mark.parametrize("cell", list(CELLS))
def test_weight_shards_are_slices_of_the_whole(worlds, reference, cell):
    """Drawn as shards: the columns of the one-process ``init_params``;
    carried from ``repro``: the columns of its numpy leaves; bit for bit,
    z, x, B, C and dt boxes of ``w_in`` included."""
    _, _, model, _ = CELLS[cell]
    cfg = _cfg(cell)
    whole = dict(_flat(tfm.init_params(cfg, seed=0, device="cpu")))
    tree, _ = _weights(reference, cell)
    carried = dict(_flat(tree))
    for run in worlds[cell]:
        c = run["coords"]["model"]
        drawn, params = dict(_flat(run["drawn"])), dict(_flat(run["params"]))
        assert sorted(drawn) == sorted(whole) == sorted(params)
        for name, leaf in whole.items():
            want = _expected(cfg, name, leaf, c, model)
            assert drawn[name].shape == want.shape, name
            assert torch.equal(drawn[name], want), name
            np.testing.assert_array_equal(
                params[name].numpy(),
                _expected(cfg, name, carried[name], c, model), err_msg=name)


@pytest.mark.parametrize("groups,model", [(1, 2), (1, 4), (2, 4), (4, 2)])
def test_shards_drawn_in_pieces_are_columns_of_the_whole_draw(monkeypatch,
                                                              groups, model):
    """bf16 weights drawn in pieces of 1 001 elements (``layers.DRAW`` cut:
    every Mamba-2 leaf of the reduced mamba2 is drawn piecewise, its
    column boxes joined as they come): each rank's shard bit for bit its
    columns of the whole tree drawn in the same pieces, for every rank of
    the model axis."""
    cfg = dataclasses.replace(_over(MAMBA, reduced(get_config(MAMBA)),
                                    groups), param_dtype="bfloat16")
    monkeypatch.setattr(layers, "DRAW", 1001)
    whole = dict(_flat(tfm.init_params(cfg, seed=0, device="cpu")))
    for c in range(model):
        mesh = types.SimpleNamespace(shape={"data": 1, "model": model},
                                     coords={"data": 0, "model": c})
        drawn = dict(_flat(tp.init_shard_params(cfg, mesh, seed=0,
                                                device="cpu")))
        for name, leaf in whole.items():
            want = _expected(cfg, name, leaf, c, model)
            assert torch.equal(drawn[name], want), (name, c)


def test_a_rank_holds_its_groups():
    """Where the axis divides the groups a rank holds groups / model of
    them, where the groups divide the axis the one its heads read."""
    for groups, model, held in ((1, 4, [1] * 4), (2, 4, [1] * 4),
                                (4, 2, [2, 2]), (2, 2, [1, 1])):
        cfg = _over(MAMBA, reduced(get_config(MAMBA)), groups)
        n = cfg.ssm.d_state
        for c, want in enumerate(held):
            cols = head_columns(cfg.ssm, cfg.d_model, model, c, "conv")
            assert (cols[1][1] - cols[1][0]) // n == want
            _, conv, _, _ = _columns(cfg, model, c)
            assert np.array_equal(np.concatenate(
                [np.arange(lo, hi) for lo, hi in cols]), conv)


# ----------------------------------------------------------- the logits

def _own_rows(cell, run):
    data = CELLS[cell][1]
    return _rows(data, run["coords"]["data"])


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
        for other in runs:      # the model group's gathered logits agree
            if other["coords"]["data"] == run["coords"]["data"]:
                for key in ("forward", "prefill", "steps"):
                    assert torch.equal(run[key], other[key]), key


@pytest.mark.parametrize("cell", list(CELLS))
def test_cache_shards_after_the_steps_are_slices(worlds, one_process, cell):
    """Each rank's cache after the steps: its rows and heads of the
    one-process cache (the conv state its x, B and C channels), within
    1e-5."""
    _, data, model, _ = CELLS[cell]
    cfg = _cfg(cell)
    assert kv_head_pad(cfg, model) == 1
    want_all = one_process[cell]["cache"]
    for run in worlds[cell]:
        c = run["coords"]["model"]
        rows = _own_rows(cell, run)
        assert run["pos"] == P0 + STEPS
        assert sorted(run["cache"]) == sorted(want_all)
        for name, whole in want_all.items():
            whole = whole[:, rows]
            if name == "ssm/conv":
                want = whole[..., _columns(cfg, model, c)[1]]
            else:          # SSM state [L, B, nh, ..], KV [L, B, Hkv, ..]
                want = whole[:, :, _heads(whole.shape[2], model, c)]
            got = run["cache"][name]
            assert got.shape == want.shape, name
            assert _err(got, want) <= TOL_PORT, (name, run["coords"])


# ------------------------------------------------------------ the bytes

def _reduce_bytes(cfg, rows, seq, frames):
    """The f32 bytes a rank all-reduces with each peer in a forward of
    ``rows`` x ``seq`` decoder tokens (and ``frames`` encoder frames): a
    [T, d_model] for the embedding, each Mamba-2 ``w_out``, each
    attention ``wo`` (the cross's too) and each dense FFN ``w_out``, over
    the encoder's T for its blocks, and each Mamba-2 norm's [T, 1] sum of
    squares."""
    t, d = rows * seq, cfg.d_model
    if cfg.family == "encdec":
        return 4 * d * ((1 + 3 * cfg.n_layers) * t
                        + 2 * cfg.encoder_layers * rows * frames)
    sites = (len(tfm._hybrid_segments(cfg)) - 1
             if cfg.family == "hybrid" else 0)
    return 4 * t * ((1 + cfg.n_layers + 2 * sites) * d + cfg.n_layers)


@pytest.mark.parametrize("cell", list(CELLS))
def test_bytes_per_kind_equal_their_formula(worlds, cell):
    """To each other rank of its model group a rank sends the all-reduces
    of ``_reduce_bytes`` and its f32 logits [rows, positions, V / model]
    (positions: S for ``forward``, 1 for ``prefill`` and a step); nothing
    to any other rank, nothing else."""
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
            reduce = times * _reduce_bytes(cfg, rows, seq, frames)
            gather = times * rows * positions * cfg.vocab_size // model * 4
            want = {"p2p": [0] * len(runs), "scalar": [0] * len(runs),
                    "reduce": [reduce if r in peers else 0
                               for r in range(len(runs))],
                    "gather": [gather if r in peers else 0
                               for r in range(len(runs))]}
            assert run[key] == want, (cell, key, run["coords"])


# ---------------------------------------------------- what stays as it was

@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_sizes_from_the_weights_are_the_configs_off_ranks(arch):
    """With no ranked model axis the Mamba-2 code's sizes, read from its
    weights (``local_sizes``), are the config's: full size and reduced,
    and with other group counts."""
    for cfg in (get_config(arch), reduced(get_config(arch)),
                _over(arch, reduced(get_config(arch)), 2),
                _over(arch, reduced(get_config(arch)), 4)):
        p = tfm.abstract_params(cfg)["ssm"]["mamba"]
        ssm = cfg.ssm
        assert local_sizes(p, ssm) == (ssm.d_inner(cfg.d_model),
                                       ssm.n_heads(cfg.d_model),
                                       ssm.n_groups), cfg.name


if __name__ == "__main__":
    _write_reference(sys.argv[1])
