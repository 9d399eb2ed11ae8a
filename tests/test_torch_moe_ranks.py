"""The moe family on a model axis of rank processes, on the CPU: the
("data", "model") mesh laid on spawned processes joined into a gloo group
(``launch.mesh.Mesh(..., group=)``, ``dist.tensor_parallel``), with expert
parallelism (``models/moe.py``) and MLA's heads per rank
(``models/transformer.py``).

The reduced grok-1-314b (GQA, 4 query heads over 2 KV heads of 32, 8
experts top-2, softmax router, GELU, 2 MoE layers) and deepseek-v3-671b
(MLA over 4 heads with its latent cache, one dense layer then one MoE
layer, 8 routed experts top-8 and one shared, sigmoid router, SwiGLU),
f32 compute over their bf16 weights, with a nonzero router bias. Cells:
(1, 2), (2, 2) and (1, 4) meshes of ranks for each; grok on (1, 4) is also
the half-head case (``kv_head_pad`` 2); grok with 6 experts on (1, 4) is
the hidden-dim fallback (4 does not divide 6: every rank holds every
expert's quarter of the hidden dim). deepseek runs at capacity factor 0.5
(``REPRO_MOE_CF``, read by both packages): its top-8 of 8 would keep every
slot at the config's.

- ``forward`` logits [B, S, V], ``prefill``, and 4 greedy serve steps from
  a cache of seeded contents against ``repro``'s ``forward`` and
  ``decode_step`` on 4 forced host devices, params and cache placed by
  ``param_specs``/``cache_specs`` on an Auto-axis ``jax.sharding.Mesh``,
  run op by op (``jax.disable_jit()`` and ``REPRO_REMAT=none``, so that
  its layer scan runs in Python; an ``.npz`` from this file's script
  mode): max|port - repro| / max|repro| <= 1e-4, the greedy tokens equal;
- the same against the one-process port under the same logical mesh
  (the sums over ranks in another order only): <= 1e-5, every rank's
  gathered logits equal;
- the dispatch of every MoE layer in ``forward`` and in each step (the
  experts, the positions in them, the kept mask), read from ``repro``'s
  own scatter call (standing in for ``jax`` inside ``repro.models.moe``,
  as ``tests/test_torch_moe.py`` does) and from the one-process port:
  equal bit for bit, row by row (a data rank's is its own row);
- each rank's weights, drawn as shards (``init_shard_params``, with
  ``layers.DRAW`` cut so that every bf16 stack is drawn in pieces that
  straddle experts) and carried from ``repro``'s numpy parameters: bit for
  bit the slices of the whole trees, taken here leaf by leaf by role (the
  router, ``wq_a`` and ``wkv_a`` whole);
- MLA's latent cache whole on every rank after the steps: the ranks' equal
  bit for bit and within 1e-5 of the one-process cache;
- the bytes each rank sends each peer, by kind, in ``forward``,
  ``prefill`` and the steps equal their formula: one f32 [rows, seq,
  d_model] all-reduce a rank for the embedding, each attention ``wo``,
  each dense ``w_out``, each MoE combine and each shared ``w_out`` (one
  collective with the combine, its bytes twice), and the logits' gather;
- the launcher serves both archs on ranks.

The rank functions live here (a spawned child imports this module, which
imports nothing of JAX at its top). Each world is spawned once for the
module: one of 2 ranks, one of 4.
"""

import ast
import contextlib
import dataclasses
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
from repro_torch.dist.ctx import launch_mesh
from repro_torch.dist.sharding import kv_head_pad
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import (params_from_reference,
                                        shard_params_from_reference)
from repro_torch.serve.decode import make_serve_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# batch, prompt, cache positions, positions filled, greedy steps
B, S, MAX_SEQ, P0, STEPS = 4, 16, 24, 12, 4
# name -> (arch, data, model, routed experts, REPRO_MOE_CF)
CELLS = {"grok-tp2": ("grok-1-314b", 1, 2, 8, ""),
         "grok-dp2-tp2": ("grok-1-314b", 2, 2, 8, ""),
         "grok-tp4": ("grok-1-314b", 1, 4, 8, ""),
         "grok6-tp4": ("grok-1-314b", 1, 4, 6, ""),
         "deepseek-tp2": ("deepseek-v3-671b", 1, 2, 8, "0.5"),
         "deepseek-dp2-tp2": ("deepseek-v3-671b", 2, 2, 8, "0.5"),
         "deepseek-tp4": ("deepseek-v3-671b", 1, 4, 8, "0.5")}
WORLDS = {2: ["grok-tp2", "deepseek-tp2"],
          4: ["grok-dp2-tp2", "grok-tp4", "grok6-tp4", "deepseek-dp2-tp2",
              "deepseek-tp4"]}
TOL_REF, TOL_PORT = 1e-4, 1e-5
# the piece of a piecewise bf16 draw: a reduced expert block is 16 384
# elements, so pieces of 3 001 straddle experts
DRAW = 3001


def _cfg(cell):
    arch, _, _, experts, _ = CELLS[cell]
    cfg = reduced(get_config(arch), compute_dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=experts))


def _weights_key(cell):
    """Cells share ``repro``'s weights by (arch, experts)."""
    arch, _, _, experts, _ = CELLS[cell]
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


def _inputs(cfg, model):
    """The prompt [B, S], the cache's seeded leaves per segment (GQA: k and
    v [L, B, Hkv·pad, MAX_SEQ, hd], each KV head repeated ``kv_head_pad``
    times; MLA: ckv [L, B, MAX_SEQ, r] and k_rope [.., rope]) filled at
    positions < P0, and the first decode tokens [B], from numpy with a
    seed."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    cache = {}
    for seg, depth in tfm.layer_kinds(cfg).items():
        if cfg.attention == "mla":
            shapes = [(depth, B, MAX_SEQ, cfg.mla.kv_lora_rank),
                      (depth, B, MAX_SEQ, cfg.mla.qk_rope_dim)]
        else:
            shapes = [(depth, B, cfg.n_kv_heads, MAX_SEQ, cfg.head_dim)] * 2
        leaves = []
        for shape in shapes:
            a = np.zeros(shape, np.float32)
            seq = 2 if cfg.attention == "mla" else 3
            fill = list(shape)
            fill[seq] = P0
            a[(slice(None),) * seq + (slice(0, P0),)] = \
                rng.standard_normal(fill)
            if cfg.attention != "mla":
                a = np.repeat(a, kv_head_pad(cfg, model), axis=2)
            leaves.append(a)
        cache[seg] = tuple(leaves)
    return toks, cache, rng.integers(0, cfg.vocab_size, (B,))


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


def _param_dtype(cfg, tree):
    """A tree of tensors in ``cfg``'s parameter dtype (the ``.npz`` holds
    ``repro``'s bf16 leaves as f32, exactly)."""
    if isinstance(tree, dict):
        return {k: _param_dtype(cfg, v) for k, v in tree.items()}
    return tree.to(tfm.dtype_of(cfg.param_dtype))


def _rows(data, d):
    """The rows of the batch of data coordinate ``d``."""
    n = B // data
    return slice(d * n, (d + 1) * n)


def _sent(net):
    return {k: list(v) for k, v in net.bytes.items()}


@contextlib.contextmanager
def _routes(out: list):
    """Each ``moe.route`` call's (experts, positions, kept mask) appended
    to ``out``, in call order (one a dispatch row)."""
    route = moe.route

    def recording(xt, p, cfg_moe):
        r = route(xt, p, cfg_moe)
        out.append((r.expert, r.pos, r.keep))
        return r

    moe.route = recording
    try:
        yield out
    finally:
        moe.route = route


def _serve(cfg, params, first, cache, routes):
    """STEPS greedy serve steps: (logits, tokens, the cache after)."""
    step = make_serve_step(cfg)
    tok, logits, tokens = first, [], []
    with _routes(routes):
        for _ in range(STEPS):
            tok, lg, cache = step(params, tok, cache)
            logits.append(lg)
            tokens.append(tok)
    return torch.stack(logits), torch.stack(tokens), cache


# ------------------------------------------------------ rank functions

def moe_cell(rank, world, ref_path, cell, *, device):
    """One cell on this rank: its weights carried from ``repro``'s and
    drawn as shards (pieces of DRAW), then under ``launch_mesh`` its rows'
    ``forward`` and ``prefill`` logits and STEPS greedy serve steps from
    its shard of the seeded cache, with the dispatch of every MoE call,
    the bytes each sent by kind, and its cache after."""
    _, data, model, _, cf = CELLS[cell]
    cfg = _cfg(cell)
    key = _weights_key(cell)
    with np.load(ref_path) as f:
        tree = _unflat({k.split("/", 1)[1]: f[k] for k in f.files
                        if k.startswith(f"params-{key}/")})
    mesh = Mesh((data, model), ("data", "model"), device,
                group=dist.group.WORLD)
    params = _param_dtype(cfg, shard_params_from_reference(cfg, tree, mesh,
                                                           device))
    layers.DRAW = DRAW
    drawn = tp.init_shard_params(cfg, mesh, seed=0, device=device)
    toks, cache, first = _inputs(cfg, model)
    rows = _rows(data, mesh.coords["data"])
    net = mesh.transport
    out = {"coords": mesh.coords, "params": params, "drawn": drawn,
           "forward_routes": []}
    with torch.inference_mode(), launch_mesh(mesh, global_batch=B), \
            _capacity(cf):
        tokens = torch.from_numpy(toks[rows]).to(device)
        net.reset()
        with _routes(out["forward_routes"]):
            out["forward"] = tfm.forward(cfg, params, tokens=tokens)[0]
        out["forward_bytes"] = _sent(net)
        net.reset()
        out["prefill"] = tfm.prefill(cfg, params, tokens=tokens)
        out["prefill_bytes"] = _sent(net)
        whole = tfm.DecodeCache(pos=P0, layers={
            seg: tuple(torch.from_numpy(a).to(device) for a in leaves)
            for seg, leaves in cache.items()})
        net.reset()
        out["step_routes"] = []
        out["steps"], out["tokens"], after = _serve(
            cfg, params, torch.from_numpy(first[rows]).to(device),
            tp.shard_cache(cfg, whole, mesh), out["step_routes"])
        out["step_bytes"] = _sent(net)
    out.update(cache=after.layers, pos=after.pos)
    return out


# ------------------------------------------------------------- worlds

def _write_reference(path):
    """``repro``'s parameters (seed 0, a seeded router bias) per (arch,
    experts) and, per cell, its ``forward`` logits, STEPS greedy
    ``decode_step``s' logits and tokens and every MoE scatter's (experts,
    positions, kept mask) [R, T, k], op by op with params and cache placed
    by its specs on an Auto-axis mesh of the cell's shape over the 4 host
    devices (this file's script mode)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jx_base
    from repro.configs.registry import get_config as jx_get_config
    from repro.dist import ctx as jx_ctx
    from repro.dist import sharding as jx_sh
    from repro.models import moe as jx_moe
    from repro.models import transformer as jx_tfm

    class Dispatch:
        """Stands in for ``jax`` inside ``repro.models.moe``: records the
        arguments of each ``vmap``-ed scatter (tokens, experts, positions,
        kept)."""

        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            return getattr(jax, name)

        def vmap(self, fn, *args, **kwargs):
            mapped = jax.vmap(fn, *args, **kwargs)

            def run(*xs):
                if len(xs) == 4:
                    self.calls.append([np.asarray(x) for x in xs[1:]])
                return mapped(*xs)
            return run

    def jcfg_of(cell):
        arch, _, _, experts, _ = CELLS[cell]
        jcfg = jx_base.reduced(jx_get_config(arch), compute_dtype="float32")
        return dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_experts=experts))

    out, weights = {}, {}
    for cell in CELLS:
        key = _weights_key(cell)
        if key in weights:
            continue
        jp = jx_tfm.init_params(jcfg_of(cell), jax.random.key(0))
        bias = jp["moe"]["moe"]["router_bias"]
        jp["moe"]["moe"]["router_bias"] = jnp.asarray(
            np.random.default_rng(7).standard_normal(bias.shape) * 0.1,
            bias.dtype)
        weights[key] = jp
        for name, a in _flat(jax.tree.map(np.asarray, jp)):
            out[f"params-{key}/{name}"] = a.astype(np.float32)  # exact
    for cell, (_, data, model, _, cf) in CELLS.items():
        jcfg = jcfg_of(cell)
        jp = weights[_weights_key(cell)]
        toks, cache_np, first = _inputs(_cfg(cell), model)
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:data * model]).reshape(data, model),
            ("data", "model"))
        axes = jx_sh.batch_axis(mesh, B)
        jx_ctx.set_batch_axes(axes)
        rec = Dispatch()
        real = jx_moe.jax
        jx_moe.jax = rec
        try:
            with _capacity(cf), jx_ctx.use_mesh(mesh), jax.disable_jit():
                p_specs = jx_sh.sanitize_specs(
                    jx_sh.param_specs(jcfg, model_axis=model),
                    jx_tfm.abstract_params(jcfg), mesh)
                params = jax.device_put(jp, jx_sh.named_shardings(mesh,
                                                                  p_specs))
                logits = jx_tfm.forward(jcfg, params,
                                        tokens=jnp.asarray(toks))[0]
                n_forward = len(rec.calls)
                cache = jx_tfm.DecodeCache(
                    pos=jnp.asarray(P0, jnp.int32), layers={
                        seg: tuple(jnp.asarray(a) for a in leaves)
                        for seg, leaves in cache_np.items()})
                shapes = jax.eval_shape(lambda: cache)
                c_specs = jx_sh.sanitize_specs(jx_sh.cache_specs(
                    jcfg, shapes, axes, model_axis=model), shapes, mesh)
                cache = jax.tree.map(
                    lambda x, s: jax.device_put(x, jax.NamedSharding(mesh,
                                                                     s)),
                    cache, c_specs, is_leaf=lambda x: hasattr(x, "shape"))
                tok = jnp.asarray(first, jnp.int32)
                steps, tokens = [], []
                for _ in range(STEPS):
                    lg, cache = jx_tfm.decode_step(jcfg, params, tok, cache)
                    tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
                    steps.append(np.asarray(lg))
                    tokens.append(np.asarray(tok))
        finally:
            jx_moe.jax = real
            jx_ctx.set_batch_axes(None)
        out[f"{cell}/forward"] = np.asarray(logits)
        out[f"{cell}/steps"] = np.stack(steps)
        out[f"{cell}/tokens"] = np.stack(tokens)
        out[f"{cell}/n_forward"] = np.asarray(n_forward)
        for i, call in enumerate(rec.calls):
            for name, a in zip(("expert", "pos", "keep"), call):
                out[f"{cell}/route{i}/{name}"] = a
        for seg, leaves in cache.layers.items():
            for i, a in enumerate(leaves):
                out[f"{cell}/cache/{seg}/{i}"] = np.asarray(a)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s outputs, from this file's script mode on 4 forced host
    devices; ``path`` is the ``.npz`` the ranks read the weights from."""
    path = tmp_path_factory.mktemp("jax_moe_ranks") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]),
               REPRO_REMAT="none")
    env.pop("REPRO_MOE_CF", None)
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
            (moe_cell, (reference["path"], c), {}) for c in cells],
            device="cpu", timeout=600)
        for i, c in enumerate(cells):
            out[c] = [r[i] for r in runs]
    return out


def _weights(reference, cell):
    """``repro``'s parameters as numpy arrays and as the port's tensors."""
    key = _weights_key(cell)
    tree = _unflat({k.split("/", 1)[1]: v for k, v in reference.items()
                    if k.startswith(f"params-{key}/")})
    return tree, _param_dtype(_cfg(cell), params_from_reference(
        tree, device="cpu"))


@pytest.fixture(scope="module")
def one_process(reference):
    """Per cell, the one-process port under the cell's logical mesh on the
    same weights and inputs: forward (with its dispatch), prefill, the
    serve steps' logits and tokens (with their dispatch) from the whole
    cache, and that cache after them."""
    out = {}
    for cell, (_, data, model, _, cf) in CELLS.items():
        cfg = _cfg(cell)
        _, params = _weights(reference, cell)
        toks, cache, first = _inputs(cfg, model)
        mesh = Mesh((data, model), ("data", "model"), "cpu")
        got = {"forward_routes": [], "step_routes": []}
        with torch.inference_mode(), launch_mesh(mesh, global_batch=B), \
                _capacity(cf):
            tokens = torch.from_numpy(toks)
            with _routes(got["forward_routes"]):
                got["forward"] = tfm.forward(cfg, params, tokens=tokens)[0]
            got["prefill"] = tfm.prefill(cfg, params, tokens=tokens)
            whole = tfm.DecodeCache(pos=P0, layers={
                seg: tuple(torch.from_numpy(a) for a in leaves)
                for seg, leaves in cache.items()})
            got["steps"], got["tokens"], after = _serve(
                cfg, params, torch.from_numpy(first), whole,
                got["step_routes"])
        got["cache"] = after.layers
        out[cell] = got
    return out


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ----------------------------------------------------------- the logits

@pytest.mark.parametrize("cell", list(CELLS))
def test_moe_ranked_logits_match_reference(worlds, reference, cell):
    data = CELLS[cell][1]
    for run in worlds[cell]:
        rows = _rows(data, run["coords"]["data"])
        want = reference[f"{cell}/forward"][rows]
        assert run["forward"].shape == want.shape
        assert _err(run["forward"], want) <= TOL_REF, run["coords"]
        assert _err(run["prefill"], want[:, -1]) <= TOL_REF, run["coords"]
        steps = reference[f"{cell}/steps"][:, rows]
        assert _err(run["steps"], steps) <= TOL_REF, run["coords"]
        np.testing.assert_array_equal(run["tokens"].numpy(),
                                      reference[f"{cell}/tokens"][:, rows])


@pytest.mark.parametrize("cell", list(CELLS))
def test_moe_ranked_logits_match_one_process(worlds, one_process, cell):
    """Within 1e-5 of the one-process port under the same logical mesh,
    and every rank of a model group gathers the same logits."""
    data = CELLS[cell][1]
    want = one_process[cell]
    for run in worlds[cell]:
        rows = _rows(data, run["coords"]["data"])
        for key in ("forward", "prefill"):
            assert _err(run[key], want[key][rows]) <= TOL_PORT, (key, run[
                "coords"])
        assert _err(run["steps"], want["steps"][:, rows]) <= TOL_PORT
        assert torch.equal(run["tokens"], want["tokens"][:, rows])
        peers = [r for r in worlds[cell]
                 if r["coords"]["data"] == run["coords"]["data"]]
        for key in ("forward", "prefill", "steps"):
            assert all(torch.equal(run[key], p[key]) for p in peers), key


# ------------------------------------------------------------ the routing

def _reference_routes(reference, cell):
    """``repro``'s scatter calls in order: (experts, positions, kept), each
    [R, T, k]; and how many of them the forward made."""
    out, i = [], 0
    while f"{cell}/route{i}/keep" in reference:
        out.append(tuple(reference[f"{cell}/route{i}/{n}"]
                         for n in ("expert", "pos", "keep")))
        i += 1
    return out, int(reference[f"{cell}/n_forward"])


@pytest.mark.parametrize("cell", list(CELLS))
def test_moe_kept_masks_match_reference(worlds, one_process, reference,
                                        cell):
    """Every MoE layer's dispatch, in the forward and in each step, bit
    for bit ``repro``'s in each dispatch row, on every rank (a data rank
    routes its own row) and in the one-process port under the logical
    mesh (one route call a row)."""
    data = CELLS[cell][1]
    want, n_forward = _reference_routes(reference, cell)
    moe_layers = tfm.layer_kinds(_cfg(cell))["moe"]
    assert n_forward == moe_layers and len(want) == moe_layers * (1 + STEPS)
    logical = (one_process[cell]["forward_routes"]
               + one_process[cell]["step_routes"])
    assert len(logical) == len(want) * data
    for i, call in enumerate(want):
        for d in range(data):
            for name, got, ref in zip(("expert", "pos", "keep"),
                                      logical[i * data + d], call):
                np.testing.assert_array_equal(got.numpy(), ref[d],
                                              err_msg=f"{name} {i} {d}")
    for run in worlds[cell]:
        got = run["forward_routes"] + run["step_routes"]
        assert len(got) == len(want)
        d = run["coords"]["data"]
        for i, (mine, call) in enumerate(zip(got, want)):
            for name, a, ref in zip(("expert", "pos", "keep"), mine, call):
                np.testing.assert_array_equal(a.numpy(), ref[d],
                                              err_msg=f"{name} {i}")
    kept = np.concatenate([c[2].ravel() for c in want])
    assert not kept.all()                         # slots were dropped


# ------------------------------------------------------------ the shards

REPLICATED = {"ln1", "ln2", "final_norm", "q_norm", "k_norm", "q_ln",
              "kv_ln", "router_bias"}
WHOLE = {"router", "wq_a", "wkv_a"}
COLUMNS = {"wq", "w_gate", "w_in", "lm_head", "wq_b", "wkv_b",
           "shared_w_gate", "shared_w_in"}
ROWS = {"wo", "w_out", "shared_w_out"}


def _expected(cfg, name, leaf, c, model):
    """Rank ``c``'s (its model coordinate) slice of the whole leaf
    ``name``, by its role in the tensor-parallel layer."""
    path = name.split("/")
    last = path[-1]
    hd, pad = cfg.head_dim, kv_head_pad(cfg, model)

    def split(dim):
        n = leaf.shape[dim] // model
        idx = [slice(None)] * leaf.ndim
        idx[dim] = slice(c * n, (c + 1) * n)
        return leaf[tuple(idx)]

    if last in REPLICATED or last in WHOLE:
        return leaf
    if last == "embed":
        return split(0)
    if "moe" in path[:-1] and last in ("w_in", "w_gate", "w_out"):
        if cfg.moe.n_experts % model == 0:        # expert parallelism
            return split(1)
        return split(-2 if last == "w_out" else -1)  # the hidden dim
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
def test_moe_weight_shards_are_slices_of_the_whole(worlds, reference,
                                                   monkeypatch, cell):
    """Drawn as shards, bf16 stacks in pieces of DRAW that straddle
    experts: the slices of the one-process ``init_params`` drawn with the
    same pieces; carried from ``repro``: the slices of its numpy leaves;
    bit for bit. The router is whole on every rank."""
    _, _, model, _, _ = CELLS[cell]
    cfg = _cfg(cell)
    monkeypatch.setattr(layers, "DRAW", DRAW)
    whole = dict(_flat(tfm.init_params(cfg, seed=0, device="cpu")))
    assert whole["moe/moe/w_in"].numel() > 4 * DRAW
    tree, _ = _weights(reference, cell)
    carried = dict(_flat(tree))
    for run in worlds[cell]:
        c = run["coords"]["model"]
        drawn, params = dict(_flat(run["drawn"])), dict(_flat(run["params"]))
        assert sorted(drawn) == sorted(whole) == sorted(params)
        for name, leaf in whole.items():
            assert torch.equal(drawn[name],
                               _expected(cfg, name, leaf, c, model)), name
            np.testing.assert_array_equal(
                params[name].float().numpy(), np.asarray(
                    _expected(cfg, name, carried[name], c, model),
                    np.float32), err_msg=name)
        assert torch.equal(drawn["moe/moe/router"], whole["moe/moe/router"])


def test_expert_parallel_and_hidden_dim_shards():
    """(1, 4): 8 experts go 2 a rank; 6 experts do not divide, so each rank
    holds all 6 with a quarter of the hidden dim (``w_out`` its rows); the
    spec trees stay ``repro``'s (the router's spec shards it, the rank
    holds it whole)."""
    for cell, local, f in (("grok-tp4", 2, 128), ("grok6-tp4", 6, 32)):
        cfg = _cfg(cell)
        specs = tp.param_shard_specs(cfg, Mesh((1, 4), ("data", "model"),
                                               "meta"))
        assert specs["moe"]["moe"]["router"] != tp.P(None, None, None)
        shapes = {n: tuple(v.shape) for n, v in _flat(tfm.abstract_params(
            cfg))}
        mesh = Mesh((1, 4), ("data", "model"), "meta")
        mesh.coords = {"data": 0, "model": 3}
        for name, want in (("w_in", (2, local, 128, f)),
                           ("w_out", (2, local, f, 128))):
            spec = specs["moe"]["moe"][name]
            idx = tp.shard_index(spec, shapes[f"moe/moe/{name}"], mesh)
            assert torch.empty(shapes[f"moe/moe/{name}"],
                               device="meta")[idx].shape == want


def test_mla_latent_cache_is_whole_on_every_rank(worlds, one_process):
    """deepseek: each rank's latent cache after the steps holds every
    position of its rows (the specs would split the sequence), the ranks
    of a model group bit for bit the same, within 1e-5 of one process."""
    for cell in ("deepseek-tp2", "deepseek-dp2-tp2", "deepseek-tp4"):
        data = CELLS[cell][1]
        want = one_process[cell]["cache"]
        for run in worlds[cell]:
            assert run["pos"] == P0 + STEPS
            rows = _rows(data, run["coords"]["data"])
            for seg, leaves in run["cache"].items():
                for i, got in enumerate(leaves):
                    assert got.shape[2] == MAX_SEQ
                    assert _err(got, want[seg][i][:, rows]) <= TOL_PORT
                    assert all(torch.equal(got, r["cache"][seg][i])
                               for r in worlds[cell]
                               if r["coords"]["data"]
                               == run["coords"]["data"])


@pytest.mark.parametrize("cell", list(CELLS))
def test_moe_bytes_per_kind_equal_their_formula(worlds, cell):
    """To each other rank of its model group, a rank sends one f32 [rows,
    seq, d_model] all-reduce for the embedding, each attention ``wo``,
    each dense ``w_out``, each MoE combine and each shared ``w_out`` (in
    one collective with the combine), and its f32 logits [rows,
    positions, V / model] (positions: S for ``forward``, 1 for ``prefill``
    and a step); nothing to any other rank, nothing else."""
    _, data, model, _, _ = CELLS[cell]
    cfg = _cfg(cell)
    kinds = tfm.layer_kinds(cfg)
    dense, moes = kinds.get("dense", 0), kinds["moe"]
    shared = 1 if cfg.moe.n_shared_experts else 0
    per = 1 + 2 * dense + moes * (2 + shared)
    rows = B // data
    runs = worlds[cell]
    for run in runs:
        peers = [r for r, other in enumerate(runs)
                 if other["coords"]["data"] == run["coords"]["data"]
                 and other["coords"] != run["coords"]]
        for key, seq, positions, times in (("forward_bytes", S, S, 1),
                                           ("prefill_bytes", S, 1, 1),
                                           ("step_bytes", 1, 1, STEPS)):
            reduce = times * per * rows * seq * cfg.d_model * 4
            gather = times * rows * positions * cfg.vocab_size // model * 4
            want = {"p2p": [0] * len(runs), "scalar": [0] * len(runs),
                    "reduce": [reduce if r in peers else 0
                               for r in range(len(runs))],
                    "gather": [gather if r in peers else 0
                               for r in range(len(runs))]}
            assert run[key] == want, (cell, key, run["coords"])


# ----------------------------------------------------------- launcher

@pytest.mark.parametrize("arch,ranks_,extra", [
    ("grok-1-314b", 4, ("--layers", "3")), ("deepseek-v3-671b", 2, ())])
def test_serve_launcher_serves_moe_on_ranks(arch, ranks_, extra):
    """``launch.serve --ranks`` serves both moe archs (grok cut to 3
    layers by ``--layers``) and prints from rank 0 only."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--arch", arch, "--host-devices", str(ranks_),
         "--ranks", "--batch", "4", "--tokens", "4", *extra],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith(f"device: cpu, arch={arch}, mesh: {{'data': "
                               f"1, 'model': {ranks_}}} on {ranks_} rank "
                               "processes")
    assert lines[1].startswith("decoded 4 x batch 4: ") and len(lines) == 2
    sample = ast.literal_eval(lines[1].split("sample ")[1])
    assert len(sample) == 4 and all(0 <= t < 512 for t in sample)


if __name__ == "__main__":
    _write_reference(sys.argv[1])
