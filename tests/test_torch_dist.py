"""The port's distribution layer against the JAX package's, on the CPU.

- spec trees, for every arch in the registry at model axis 2, 4 and 16:
  ``param_specs``, ``kv_head_pad``, ``cache_specs`` (on ``init_cache``
  stand-ins: ``jax.eval_shape`` in ``repro``, meta tensors in the port),
  ``opt_state_specs`` (AdamW and Adafactor) and ``sanitize_specs`` against
  the (16, 16) and (2, 16, 16) axis sizes equal ``repro``'s leaf for leaf
  as tuples; ``batch_axis`` on both packages' meshes; the port of
  ``tests/test_substrate.py::test_param_specs_cover_tree``;
- ``input_specs`` for every arch × shape × mesh kind (the production pod,
  the multi-pod and one device): the argument trees' shapes and dtypes
  equal ``repro``'s ``ShapeDtypeStruct``s, and their sanitized specs
  equal ``repro``'s;
- ``dist.ctx`` on the port's logical meshes: the values
  ``tests/test_dist_ctx.py`` states (``data_rows``, ``act_spec``, the
  sanitized spec at an annotation site, identity without a mesh), which
  the reference's own two ``use_mesh`` tests cannot show on this jax: its
  ``jax.make_mesh`` builds Explicit axes, under which ``annotate``
  raises;
- ``named_shardings``: the DTensor placements of sanitized specs; a
  decode cache of ``kv_head_pad``-replicated heads decodes the logits of
  the unpadded one (f32, to 1e-5);
- ``moe_ffn`` under a (data 2, model 2) mesh with batch axes "data" (2
  dispatch rows) against ``repro``'s under an Auto-axis
  ``jax.sharding.Mesh`` of 4 forced host devices, run once in a
  subprocess that writes an ``.npz``: the experts, positions and kept
  masks of each row equal exactly, the outputs to 1e-5 of their max in
  f32, on the reduced grok-1-314b and deepseek-v3-671b (and its sigmoid
  router at top-3), at the config's capacity factor and at
  ``REPRO_MOE_CF=0.5``. Inputs come from numpy with a seed.

Run as a script (``python tests/test_torch_dist.py OUT.npz``) it writes
the JAX package's MoE outputs; the module-scoped fixture does that.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import base as jx_base
from repro.configs.registry import all_archs
from repro.configs.registry import get_config as jx_get_config
from repro.dist import sharding as jx_sh
from repro.launch import specs as jx_specs
from repro.models import transformer as jx_tfm
from repro.train import optimizer as jx_opt

from repro_torch.configs import base as pt_base
from repro_torch.configs.registry import get_config
from repro_torch.dist import ctx
from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import P
from repro_torch.launch import specs
from repro_torch.launch.mesh import (Mesh, make_dev_mesh, make_host_mesh,
                                     make_pipeline_mesh,
                                     make_production_mesh)
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as pt_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = all_archs()
AXES = [2, 4, 16]
POD = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}
MOE_CASES = [("grok-1-314b", None), ("deepseek-v3-671b", None),
             ("deepseek-v3-671b", 3)]
MOE_IDS = ["grok-softmax", "deepseek-sigmoid", "deepseek-sigmoid-top3"]
MOE_TOL = 1e-5


class _Sizes:
    """A mesh to ``repro``'s spec functions: they read only ``shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _jx_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _pt_leaves(tree):
    return [tuple(s) for s in sh.spec_leaves(tree)]


def _jx_cache(cfg, b, s, pad):
    enc_out = None
    if cfg.family == "encdec":
        shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
        enc_out = (jax.ShapeDtypeStruct(shape, jax.numpy.bfloat16),) * 2
    return jax.eval_shape(lambda: jx_tfm.init_cache(
        cfg, b, s, enc_out=enc_out, kv_head_pad=pad))


def _pt_cache(cfg, b, s, pad):
    enc_out = None
    if cfg.family == "encdec":
        shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
        enc_out = tuple(torch.empty(shape, dtype=torch.bfloat16,
                                    device="meta") for _ in range(2))
    return tfm.init_cache(cfg, b, s, enc_out=enc_out, device="meta",
                          kv_head_pad=pad)


# ------------------------------------------------------------- spec trees

@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_reference(arch, axis):
    jcfg, pcfg = jx_get_config(arch), get_config(arch)
    j_abs, p_abs = jx_tfm.abstract_params(jcfg), tfm.abstract_params(pcfg)
    j_ps = jx_sh.param_specs(jcfg, model_axis=axis)
    p_ps = sh.param_specs(pcfg, model_axis=axis)
    assert _pt_leaves(p_ps) == _jx_leaves(j_ps)

    pad = sh.kv_head_pad(pcfg, axis)
    assert pad == jx_sh.kv_head_pad(jcfg, axis)

    for opt in ("adamw", "adafactor"):
        want = jx_opt.opt_state_specs(j_ps, opt, j_abs)
        got = pt_opt.opt_state_specs(p_ps, opt, p_abs)
        assert _pt_leaves(got) == _jx_leaves(want), opt

    for bn in (None, "data", ("pod", "data")):
        want = jx_sh.cache_specs(jcfg, _jx_cache(jcfg, 8, 64, pad), bn,
                                 model_axis=axis)
        got = sh.cache_specs(pcfg, _pt_cache(pcfg, 8, 64, pad), bn,
                             model_axis=axis)
        assert _pt_leaves(got) == _jx_leaves(want), bn

    for sizes in (POD, MULTI):
        mesh = _Sizes(sizes)
        want = jx_sh.sanitize_specs(j_ps, j_abs, mesh)
        got = sh.sanitize_specs(p_ps, p_abs, mesh)
        assert _pt_leaves(got) == _jx_leaves(want), sizes
        j_opt = jax.eval_shape(jx_opt.adafactor_init, j_abs)
        want = jx_sh.sanitize_specs(
            jx_opt.opt_state_specs(j_ps, "adafactor", j_abs), j_opt, mesh)
        got = sh.sanitize_specs(
            pt_opt.opt_state_specs(p_ps, "adafactor", p_abs),
            pt_opt.adafactor_init(p_abs), mesh)
        assert _pt_leaves(got) == _jx_leaves(want), sizes


@pytest.mark.parametrize("sizes", [POD, MULTI, {"data": 2, "model": 2},
                                   {"pipe": 2, "data": 4, "model": 1}],
                         ids=["pod", "multi", "host", "pipe"])
def test_batch_axis_matches_reference(sizes):
    mesh = Mesh(tuple(sizes.values()), tuple(sizes), "cpu")
    for b in (1, 2, 4, 6, 8, 16, 32, 48, 64, 256):
        assert sh.batch_axis(mesh, b) == jx_sh.batch_axis(_Sizes(sizes), b)


def test_sanitize_spec_matches_reference():
    """The cases of ``tests/test_substrate.py``'s sanitization test, and
    names the mesh lacks."""
    sizes = {"data": 16, "model": 16, "pod": 2}
    for spec, shape in (((("model", "data")), (50280, 2048)),
                        (((("pod", "data"), None)), (32, 128)),
                        (((("pod", "data"), None)), (16, 128)),
                        ((("model",)), (64, 32, 16)),
                        ((("pipe", ("data", "model"))), (8, 48)),
                        ((("model", None, ("pod", "model"))), (5, 3, 64))):
        got = sh.sanitize_spec(P(*spec), shape, sizes)
        want = jx_sh.sanitize_spec(JP(*spec), shape, sizes)
        assert tuple(got) == tuple(want), (spec, shape)
    assert sh.sanitize_spec(P(("pod", "data"), None), (16, 128), sizes) \
        == P("pod", None)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_cover_tree(arch):
    """Every param leaf gets a spec of matching rank; large matrices are
    actually sharded (not silently replicated) — the port of
    ``tests/test_substrate.py::test_param_specs_cover_tree``."""
    cfg = get_config(arch)
    specs = sh.param_specs(cfg)
    flat_s = sh.spec_leaves(specs)
    flat_p = [leaf for _, leaf in sorted(_leaves(tfm.abstract_params(cfg)))]
    assert len(flat_s) == len(flat_p)
    big_sharded = 0
    for s, p in zip(flat_s, flat_p):
        assert p.is_meta
        assert len(s) <= p.dim(), (s, p.shape)
        if p.numel() > 1e6:
            assert any(e is not None for e in s), (s, p.shape)
            big_sharded += 1
    assert big_sharded > 0


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


# ------------------------------------------------------------ input specs

def _jx_args(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]


def _pt_args(tree):
    """Shapes and dtypes of the port's argument tree in JAX's flattening
    order; the decode cache's host-int ``pos`` stands for its int32
    scalar."""
    out = []
    for leaf in sh.spec_leaves(sh.map_tree(lambda x: x, tree)):
        if isinstance(leaf, int):
            out.append(((), "int32"))
        else:
            out.append((tuple(leaf.shape),
                        str(leaf.dtype).removeprefix("torch.")))
    return out


@pytest.mark.parametrize("kind", ["pod", "multi", "1x1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, kind):
    sizes = {"pod": POD, "multi": MULTI,
             "1x1": {"data": 1, "model": 1}}[kind]
    mesh = Mesh(tuple(sizes.values()), tuple(sizes), "meta")
    jcfg, pcfg = jx_get_config(arch), get_config(arch)
    for j_cell, p_cell in zip(jx_base.shapes_for(jcfg),
                              pt_base.shapes_for(pcfg)):
        assert j_cell.name == p_cell.name
        j_args, j_specs = jx_specs.input_specs(jcfg, j_cell, _Sizes(sizes))
        p_args, p_specs = specs.input_specs(pcfg, p_cell, mesh)
        assert _pt_args(p_args) == _jx_args(j_args), j_cell.name
        assert _pt_leaves(p_specs) == _jx_leaves(j_specs), j_cell.name
        assert all(x.is_meta for x in sh.spec_leaves(
            sh.map_tree(lambda x: x, p_args)) if isinstance(x, torch.Tensor))


# -------------------------------------------------------------- dist.ctx

def test_annotate_is_identity_without_mesh():
    x = torch.ones((4, 8, 16))
    assert ctx.annotate(x, P("data", None, None)) is x
    assert ctx.get_mesh() is None
    assert ctx.data_rows() == 1


@pytest.mark.parametrize("data,model", [(1, 1), (2, 1), (2, 2), (4, 2)])
def test_use_mesh_round_trips_act_spec(data, model):
    """``tests/test_dist_ctx.py``'s statement on the port's logical mesh:
    under ``use_mesh`` the mesh is ambient, ``data_rows()`` is the data
    axis, ``annotate`` returns its input and ``act_spec`` sanitizes as the
    reference's; on exit the mesh is gone."""
    mesh = make_host_mesh(model=model, data=data, device="cpu")
    ctx.set_batch_axes(sh.batch_axis(mesh, 8))
    ctx.set_seq_shard(True)
    try:
        x = torch.ones((8, 16, 32))
        with ctx.use_mesh(mesh):
            assert ctx.get_mesh() is mesh
            assert ctx.data_rows() == mesh.shape["data"]
            assert ctx.annotate(x, ctx.act_spec()) is x
            got = sh.sanitize_spec(ctx.act_spec(), x.shape, mesh.shape)
            want = jx_sh.sanitize_spec(
                JP(ctx.batch_axes(), "model", None), x.shape, mesh.shape)
            assert tuple(got) == tuple(want)
            assert tuple(got) == ("data", "model", None)
            with ctx.suspend_annotations():
                assert ctx.get_mesh() is None and ctx.data_rows() == 1
            assert ctx.get_mesh() is mesh
        assert ctx.get_mesh() is None
    finally:
        ctx.set_batch_axes(None)
        ctx.set_seq_shard(False)


def test_annotate_drops_axes_shape_cannot_divide():
    mesh = make_host_mesh(model=2, data=2, device="cpu")
    with ctx.use_mesh(mesh):
        x = torch.ones((5, 7))
        assert ctx.annotate(x, P("model", "data")) is x
        assert sh.sanitize_spec(P("model", "data"), x.shape,
                                mesh.shape) == P(None, None)


def test_launch_mesh_sets_and_restores_policies():
    mesh = make_dev_mesh(8, device="cpu")
    assert mesh.shape == {"data": 2, "model": 4}
    with ctx.launch_mesh(mesh, global_batch=6, seq_len=32):
        assert ctx.batch_axes() == "data" and ctx.seq_shard()
        assert ctx.data_rows() == 2
    assert ctx.batch_axes() is None and not ctx.seq_shard()
    assert ctx.get_mesh() is None
    with ctx.launch_mesh(mesh, global_batch=3, seq_len=30):
        assert ctx.batch_axes() is None and not ctx.seq_shard()
        assert ctx.data_rows() == 1
    with ctx.launch_mesh(None, global_batch=8) as m:
        assert m is None and ctx.get_mesh() is None


def test_meshes():
    assert make_production_mesh().shape == POD
    multi = make_production_mesh(multi_pod=True)
    assert multi.shape == MULTI and multi.size == 512
    assert multi.axis_names == ("pod", "data", "model")
    assert make_dev_mesh(256).shape == POD
    assert make_dev_mesh(2).shape == {"data": 1, "model": 2}
    assert make_pipeline_mesh(2, 8).shape == {"pipe": 2, "data": 4,
                                              "model": 1}
    with pytest.raises(ValueError):
        make_pipeline_mesh(3, 8)


def test_named_shardings_are_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_production_mesh(multi_pod=True, device="cpu")
    tree = {"a": P(("pod", "data"), None, "model"), "b": P(),
            "c": [P(None, "data")]}
    got = sh.named_shardings(mesh, tree)
    assert got["a"] == (Shard(0), Shard(0), Shard(2))
    assert got["b"] == (Replicate(),) * 3
    assert got["c"][0] == (Replicate(), Shard(1), Replicate())
    # every leaf of a real tree: one placement per mesh axis
    cfg = get_config("yi-6b")
    abstract = tfm.abstract_params(cfg)
    specs = sh.sanitize_specs(sh.param_specs(cfg), abstract, mesh)
    shardings = sh.named_shardings(mesh, specs)
    assert shardings.keys() == specs.keys()
    assert shardings["embed"] == sh.placements(mesh, specs["embed"])
    for spec in sh.spec_leaves(specs):
        assert len(sh.placements(mesh, spec)) == 3


def test_shard_bytes():
    mesh = make_production_mesh(device="meta")
    x = torch.empty((256, 4096), dtype=torch.bfloat16, device="meta")
    assert sh.shard_bytes(x, P("data", "model"), mesh) == 256 * 4096 * 2 // 256
    assert sh.shard_bytes(x, P(None, "model"), mesh) == 256 * 4096 * 2 // 16
    assert sh.shard_bytes(x, P(), mesh) == 256 * 4096 * 2


@pytest.mark.parametrize("arch", ["yi-6b", "grok-1-314b"])
def test_kv_head_pad_cache_decodes_the_same(arch):
    """A cache of ``kv_head_pad``-replicated KV heads (what the serve
    launcher builds under a mesh) decodes the logits of the unpadded one:
    GQA repeats each KV head over its query group anyway."""
    cfg = pt_base.reduced(get_config(arch), compute_dtype="float32")
    pad = sh.kv_head_pad(cfg, 4)
    assert pad == 4 // cfg.n_kv_heads > 1
    params = tfm.init_params(cfg, seed=0, device="cpu")
    tok = torch.tensor([3, 17], dtype=torch.int64)
    caches = [tfm.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu",
                             kv_head_pad=r) for r in (1, pad)]
    for _ in range(4):
        outs = []
        for i, cache in enumerate(caches):
            logits, caches[i] = tfm.decode_step(cfg, params, tok, cache)
            outs.append(logits)
        torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
        tok = outs[0].argmax(-1)


# ----------------------------------------------------- MoE under a mesh

def _moe_cfgs(arch, top):
    jcfg = jx_base.reduced(jx_get_config(arch), compute_dtype="float32")
    pcfg = pt_base.reduced(get_config(arch), compute_dtype="float32")
    jm, pm = jcfg.moe, pcfg.moe
    if top:
        jm = dataclasses.replace(jm, experts_per_token=top)
        pm = dataclasses.replace(pm, experts_per_token=top)
    return jcfg, jm, pcfg, pm


def _case_name(arch, top, cf):
    return f"{arch}-{top or 'cfg'}-{cf or 'cfg'}"


def _write_moe_reference(path):
    """``repro``'s moe_ffn under an Auto (2, 2) mesh of 4 host devices,
    batch axes "data": per case the layer's weights, x, y and each row's
    experts, positions and kept masks (from its scatter's vmap call)."""
    import jax.numpy as jnp
    from repro.dist import ctx as jx_ctx
    from repro.models import moe as jx_moe

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    out = {}
    for arch, top in MOE_CASES:
        jcfg, jm, _, _ = _moe_cfgs(arch, top)
        jp = jx_tfm.init_params(jcfg, jax.random.key(0))
        layer = {k: np.asarray(v[0], np.float32)
                 for k, v in jp["moe"]["moe"].items()}
        layer["router_bias"] = (np.random.default_rng(7).standard_normal(
            layer["router_bias"].shape) * 0.1).astype(np.float32)
        x = np.random.default_rng(11).standard_normal(
            (4, 12, jcfg.d_model)).astype(np.float32)
        for cf in (None, "0.5"):
            name = _case_name(arch, top, cf)
            calls = []

            class Rec:
                def __getattr__(self, attr):
                    return getattr(jax, attr)

                def vmap(self, fn):
                    mapped = jax.vmap(fn)

                    def run(*xs):
                        calls.append([np.asarray(a) for a in xs])
                        return mapped(*xs)
                    return run

            if cf:
                os.environ["REPRO_MOE_CF"] = cf
            jx_ctx.set_batch_axes("data")
            saved, jx_moe.jax = jx_moe.jax, Rec()
            try:
                with jx_ctx.use_mesh(mesh):
                    assert jx_ctx.data_rows() == 2
                    y = jx_moe.moe_ffn(
                        jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in layer.items()},
                        jm, jcfg.ffn, jnp.float32)
            finally:
                jx_moe.jax = saved
                jx_ctx.set_batch_axes(None)
                os.environ.pop("REPRO_MOE_CF", None)
            _, expert, pos, keep = calls[0]
            out[f"{name}/x"] = x
            out[f"{name}/y"] = np.asarray(y)
            out[f"{name}/expert"] = expert
            out[f"{name}/pos"] = pos
            out[f"{name}/keep"] = keep
            for k, v in layer.items():
                out[f"{name}/w/{k}"] = v
    np.savez(path, **out)


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_moe_mesh") / "outputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    env.pop("REPRO_MOE_CF", None)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("cf", [None, "0.5"], ids=["cf-config", "cf-0.5"])
@pytest.mark.parametrize("arch,top", MOE_CASES, ids=MOE_IDS)
def test_moe_rows_under_mesh_match_reference(moe_reference, monkeypatch,
                                             arch, top, cf):
    if cf:
        monkeypatch.setenv("REPRO_MOE_CF", cf)
    name = _case_name(arch, top, cf)
    _, _, pcfg, pm = _moe_cfgs(arch, top)
    ref = {k.split("/", 1)[1]: v for k, v in moe_reference.items()
           if k.startswith(name + "/")}
    layer = {k[2:]: torch.from_numpy(v) for k, v in ref.items()
             if k.startswith("w/")}
    x = torch.from_numpy(ref["x"])
    mesh = make_host_mesh(model=2, data=2, device="cpu")
    with ctx.launch_mesh(mesh, global_batch=x.shape[0]):
        assert ctx.batch_axes() == "data"
        assert moe.dispatch_rows(x) == 2
        xt, routes = moe.dispatch(x, layer, pm)
        y = moe.moe_ffn(x, layer, pm, pcfg.ffn, torch.float32)
    assert xt.shape[:2] == (2, 24)
    t = xt.shape[1]
    for r, route in enumerate(routes):
        assert route.capacity == int(t * pm.experts_per_token / pm.n_experts
                                     * (float(cf) if cf else
                                        pm.capacity_factor)) + 1
        np.testing.assert_array_equal(route.expert.numpy(), ref["expert"][r])
        np.testing.assert_array_equal(route.pos.numpy(), ref["pos"][r])
        np.testing.assert_array_equal(route.keep.numpy(), ref["keep"][r])
    if cf:                        # the factor binds: slots are dropped
        assert not all(r.keep.all() for r in routes)
    err = float((y - torch.from_numpy(ref["y"])).abs().max()
                / np.abs(ref["y"]).max())
    assert err <= MOE_TOL, err
    # one row over the whole batch routes otherwise: the rows matter
    one = moe.moe_ffn(x, layer, pm, pcfg.ffn, torch.float32)
    assert moe.dispatch_rows(x) == 1
    if cf:
        assert not torch.equal(one, y)


def test_moe_rows_fall_back_to_one_when_they_do_not_divide():
    _, _, pcfg, pm = _moe_cfgs("grok-1-314b", None)
    params = tfm.init_params(pcfg, seed=0, device="cpu")
    layer = {k: v[0].float() for k, v in params["moe"]["moe"].items()}
    x = torch.randn((3, 8, pcfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    want = moe.moe_ffn(x, layer, pm, pcfg.ffn, torch.float32)
    with ctx.launch_mesh(make_host_mesh(2, 2, device="cpu"), global_batch=4):
        assert ctx.data_rows() == 2 and moe.dispatch_rows(x) == 1
        got = moe.moe_ffn(x, layer, pm, pcfg.ffn, torch.float32)
    assert torch.equal(got, want)


if __name__ == "__main__":
    _write_moe_reference(sys.argv[1])
