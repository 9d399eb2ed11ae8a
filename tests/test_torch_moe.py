"""The port's moe family against the JAX package's, on the reduced
grok-1-314b (GQA, 4 q heads over 2 KV heads, 8 experts top-2, softmax
router, GELU) and deepseek-v3-671b (MLA with its latent cache, one dense
layer then one MoE layer, 8 routed experts top-8 and one shared, sigmoid
router with bias, SwiGLU), from the same weights: ``repro``'s
``init_params`` converted to tensors (``repro_torch.models.convert``),
with a nonzero ``router_bias`` in both packages.

- ``moe_ffn`` against ``repro``'s, f32 and bf16, at the config's capacity
  factor and under ``REPRO_MOE_CF=0.5`` (read by both packages), with both
  routers (and deepseek's sigmoid router at top-3, where the bias decides
  the selection): the outputs, and the dispatch itself — the experts, the
  positions in them and the kept mask, exactly, read from the reference's
  own dispatch call;
- ``moe_ffn`` against ``moe_ref``; ties broken toward the lower expert
  index in both packages; permuting the batch permutes the outputs (the
  port's ``tests/test_substrate.py::test_moe_row_dispatch_matches_global``);
- ``forward`` logits and the collected caches (GQA (k, v), MLA (ckv,
  k_rope)) and ``prefill``, in one attention block and under
  ``REPRO_ATTN_CHUNK=16`` (MLA's q·k of 32 and v of 32 through the
  multi-chunk online softmax). In bf16 the reference runs op by op
  (``jax.disable_jit()``), as PyTorch runs: its compiled forward keeps
  fused bf16 intermediates in f32, which moves the router's near-ties, and
  a token routed to another expert changes its output by its own size. On
  reduced grok, 2 x 64 tokens, the reference's compiled logits differ from
  its op-by-op logits by 8.1e-2 (mean-relative; 4.3e-2 with no slot
  dropped), while the port's differ from the op-by-op ones by 4.5e-3;
- 8 ``decode_step``s, logits and the written caches; 10 steps over an MLA
  cache of 8 (the write past the end clamps, as in ``repro``);
- prefill of a prompt equals feeding it through ``decode_step``, with no
  slot dropped (``REPRO_MOE_CF=8``: with drops the two differ in both
  packages, since a prefill routes B·S tokens and a step B);
- greedy tokens equal to ``repro``'s (the counterpart of
  ``tests/test_train_integration.py::test_serve_greedy_decode``);
- ``python -m repro_torch.launch.serve --arch {grok-1-314b,
  deepseek-v3-671b} --reduced --device cpu`` runs.

``lm_loss`` waits for training (ROADMAP A11). Tolerances, as in
``tests/test_torch_dense.py``: f32 max|port - repro| / max|repro| <= 1e-4,
bf16 mean|port - repro| / mean|repro| <= 3e-2. Kept masks are equal
exactly. Inputs come from numpy with a seed.
"""

import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jx_base
from repro.configs.registry import get_config as jx_get_config
from repro.models import moe as jx_moe
from repro.models import transformer as jx_tfm
from repro.serve.decode import make_serve_step as jx_make_serve_step

from repro_torch.configs import base as pt_base
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as pt_serve
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import dense_init
from repro_torch.serve.decode import make_prefill_step, make_serve_step

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ARCHS = ["grok-1-314b", "deepseek-v3-671b"]
DTYPES = ["float32", "bfloat16"]
# (arch, experts per token or None for the config's): deepseek's top-8 of
# 8 selects every expert, so its sigmoid router is also run at top-3,
# where affinity + bias chooses
ROUTERS = [("grok-1-314b", None), ("deepseek-v3-671b", None),
           ("deepseek-v3-671b", 3)]
ROUTER_IDS = ["grok-softmax", "deepseek-sigmoid", "deepseek-sigmoid-top3"]


def _cfgs(arch, compute_dtype="float32"):
    return (jx_base.reduced(jx_get_config(arch), compute_dtype=compute_dtype),
            pt_base.reduced(get_config(arch), compute_dtype=compute_dtype))


@pytest.fixture(scope="module")
def weights():
    """Per arch, ``repro``'s parameters (seed 0) with a seeded nonzero
    router bias, and their conversion, made once for the module."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch)
        jp = jx_tfm.init_params(jcfg, jax.random.key(0))
        bias = jp["moe"]["moe"]["router_bias"]
        jp["moe"]["moe"]["router_bias"] = jnp.asarray(
            np.random.default_rng(7).standard_normal(bias.shape) * 0.1,
            bias.dtype)
        out[arch] = (jp, params_from_reference(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
    return out


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _err(got, want, dtype):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    diff = np.abs(got - want)
    if dtype == "float32":
        return float(diff.max() / np.abs(want).max())
    return float(diff.mean() / np.abs(want).mean())


class _Dispatch:
    """Stands in for ``jax`` inside ``repro.models.moe`` and records the
    arguments of each ``jax.vmap``-ed call: the reference's scatter gets
    (tokens, experts, positions, kept), its combine (outputs, experts,
    positions, kept, weights), each per dispatch row."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *args, **kwargs):
        mapped = jax.vmap(fn, *args, **kwargs)

        def run(*xs):
            self.calls.append([np.asarray(x) for x in xs])
            return mapped(*xs)
        return run


def _moe_layer(weights, arch, top, dtype):
    """(MoE config pair, the first MoE layer's parameters in the compute
    dtype for both packages, as ``_cast_params`` hands them over)."""
    jcfg, pcfg = _cfgs(arch, dtype)
    jm, pm = jcfg.moe, pcfg.moe
    if top:
        jm = dataclasses.replace(jm, experts_per_token=top)
        pm = dataclasses.replace(pm, experts_per_token=top)
    jp, pp = weights[arch]
    jl = jax.tree.map(lambda a: a[0].astype(getattr(jnp, dtype)),
                      jp["moe"]["moe"])
    pl = {k: v[0].to(getattr(torch, dtype))
          for k, v in pp["moe"]["moe"].items()}
    return (jcfg, jm, jl), (pcfg, pm, pl)


def _run_reference(monkeypatch, ffn, jm, jl, x, dtype):
    """``repro``'s moe_ffn on x: (y, its scatter call's arguments)."""
    rec = _Dispatch()
    with monkeypatch.context() as m:
        m.setattr(jx_moe, "jax", rec)
        y = jx_moe.moe_ffn(jnp.asarray(x, getattr(jnp, dtype)), jl, jm, ffn,
                           getattr(jnp, dtype))
    return np.asarray(y.astype(jnp.float32)), rec.calls[0]


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("cf", [None, "0.5"], ids=["cf-config", "cf-0.5"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,top", ROUTERS, ids=ROUTER_IDS)
def test_moe_ffn_matches_reference(weights, monkeypatch, arch, top, dtype,
                                   cf):
    if cf:
        monkeypatch.setenv("REPRO_MOE_CF", cf)
    (jcfg, jm, jl), (pcfg, pm, pl) = _moe_layer(weights, arch, top, dtype)
    x = _x(11, 2, 24, pcfg.d_model)
    want, (_, j_expert, j_pos, j_keep) = _run_reference(
        monkeypatch, jcfg.ffn, jm, jl, x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = moe.moe_ffn(xt, pl, pm, pcfg.ffn, getattr(torch, dtype))
    assert got.shape == xt.shape and got.dtype == xt.dtype
    assert _err(got, want, dtype) <= TOL[dtype]
    r = moe.route(xt.reshape(-1, pcfg.d_model), pl, pm)
    np.testing.assert_array_equal(r.expert.numpy(), j_expert[0])
    np.testing.assert_array_equal(r.pos.numpy(), j_pos[0])
    np.testing.assert_array_equal(r.keep.numpy(), j_keep[0])
    if cf:                        # the factor binds: slots are dropped
        assert not r.keep.all()


@pytest.mark.parametrize("cf", [None, "0.5"], ids=["cf-config", "cf-0.5"])
@pytest.mark.parametrize("arch,top", ROUTERS, ids=ROUTER_IDS)
def test_moe_ffn_matches_moe_ref(weights, monkeypatch, arch, top, cf):
    if cf:
        monkeypatch.setenv("REPRO_MOE_CF", cf)
    _, (pcfg, pm, pl) = _moe_layer(weights, arch, top, "float32")
    x = torch.from_numpy(_x(12, 3, 20, pcfg.d_model))
    got = moe.moe_ffn(x, pl, pm, pcfg.ffn, torch.float32)
    want, keep = moe.moe_ref(x, pl, pm, pcfg.ffn, torch.float32)
    assert _err(got, want.numpy(), "float32") <= TOL["float32"]
    assert torch.equal(keep, moe.route(x.reshape(-1, pcfg.d_model), pl,
                                       pm).keep)
    if cf:
        assert not keep.all()


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_ties_break_toward_the_lower_expert(monkeypatch, router):
    """Planted ties: router columns 5 and 2 equal to column 0, and one token
    of all zeros (every expert tied). Both packages take the lower index
    first, as ``lax.top_k`` does; so does ``moe_ref``."""
    rng = np.random.default_rng(3)
    d, e = 16, 8
    jm = jx_base.MoEConfig(n_experts=e, experts_per_token=3, d_ff=8,
                           router=router)
    pm = MoEConfig(n_experts=e, experts_per_token=3, d_ff=8, router=router)
    shapes = moe.moe_params_shapes(pm, d, "gelu")
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.3
         for n, s in shapes.items()}
    p["router_bias"][:] = 0.0
    p["router"][:, 5] = p["router"][:, 2] = p["router"][:, 0]
    x = _x(4, 1, 6, d)
    x[0, 3] = 0.0
    want, (_, j_expert, _, _) = _run_reference(
        monkeypatch, "gelu", jm, jax.tree.map(jnp.asarray, p), x, "float32")
    pp = {n: torch.from_numpy(a) for n, a in p.items()}
    xt = torch.from_numpy(x)
    r = moe.route(xt[0], pp, pm)
    np.testing.assert_array_equal(r.expert.numpy(), j_expert[0])
    assert r.expert[3].tolist() == [0, 1, 2]       # all tied: lowest first
    for t in range(6):                             # 0, 2, 5 tie: in order
        picked = [i for i in r.expert[t].tolist() if i in (0, 2, 5)]
        assert picked == sorted(picked)
    got = moe.moe_ffn(xt, pp, pm, "gelu", torch.float32)
    ref, keep = moe.moe_ref(xt, pp, pm, "gelu", torch.float32)
    assert _err(got, want, "float32") <= TOL["float32"]
    assert _err(ref, want, "float32") <= TOL["float32"]
    assert torch.equal(keep, r.keep)


def test_permuting_the_batch_permutes_the_outputs():
    """The port's counterpart of ``tests/test_substrate.py::
    test_moe_row_dispatch_matches_global``: with no drops (capacity factor
    8), permuting the batch permutes the outputs."""
    cfg_moe = MoEConfig(n_experts=4, experts_per_token=2, d_ff=16,
                        capacity_factor=8.0)
    d = 8
    gen = torch.Generator().manual_seed(0)
    p = {n: (torch.zeros(s) if n.endswith("bias")
             else dense_init(gen, s, 0, torch.float32))
         for n, s in sorted(moe.moe_params_shapes(cfg_moe, d,
                                                  "swiglu").items())}
    x = torch.randn((4, 6, d), generator=gen)
    y = moe.moe_ffn(x, p, cfg_moe, "swiglu", torch.float32)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    perm = torch.tensor([2, 0, 3, 1])
    y_perm = moe.moe_ffn(x[perm], p, cfg_moe, "swiglu", torch.float32)
    torch.testing.assert_close(y_perm, y[perm], rtol=1e-5, atol=1e-5)


def test_capacities_of_the_chip_cells():
    """The capacities the full-width configs get at the chip's batches:
    grok prefill 4 x 2 048 and decode at batch 8; deepseek the same, where
    a step keeps at most one token per expert (ROADMAP C5)."""
    grok, ds = (get_config(a).moe for a in ARCHS)
    assert moe.capacity(4 * 2048, grok) == 2561
    assert moe.capacity(8, grok) == 3
    assert moe.capacity(4 * 2048, ds) == 321
    assert moe.capacity(8, ds) == 1
    assert moe.capacity(2 * 512, ds) == 41


def test_port_init_has_the_reference_tree():
    for arch in ARCHS:
        jcfg, pcfg = _cfgs(arch)
        want = jax.eval_shape(lambda: jx_tfm.init_params(jcfg,
                                                         jax.random.key(0)))
        got = tfm.init_params(pcfg, seed=0, device="cpu")
        shapes = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
                  for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        mine = {jax.tree_util.keystr(p): (tuple(v.shape),
                                          str(v.dtype).replace("torch.", ""))
                for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
        assert mine == shapes
        assert tfm.layer_kinds(pcfg) == jx_tfm.layer_kinds(jcfg)
        assert not got["moe"]["moe"]["router_bias"].any()


@pytest.mark.parametrize("chunk", [None, "16"], ids=["one-block", "chunk16"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(weights, monkeypatch, arch,
                                             dtype, chunk):
    if chunk:
        monkeypatch.setenv("REPRO_ATTN_CHUNK", chunk)
    jcfg, pcfg = _cfgs(arch, dtype)
    jp, pp = weights[arch]
    toks = _tokens(1, 2, 64, pcfg.vocab_size)
    with jax.disable_jit(dtype == "bfloat16"):
        want, jcaches = jx_tfm.forward(jcfg, jp, tokens=jnp.asarray(toks),
                                       collect_cache=True)
        want_last = jx_tfm.prefill(jcfg, jp, tokens=jnp.asarray(toks))
    got, caches = tfm.forward(pcfg, pp, tokens=torch.from_numpy(toks).long(),
                              collect_cache=True)
    assert tuple(got.shape) == (2, 64, pcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    assert _err(got, want, dtype) <= TOL[dtype]
    assert caches.keys() == jcaches.keys() == tfm.layer_kinds(pcfg).keys()
    for seg in caches:
        for mine, ref in zip(caches[seg], jcaches[seg]):
            assert tuple(mine.shape) == ref.shape
            assert _err(mine, ref, dtype) <= TOL[dtype]
    last = make_prefill_step(pcfg)(pp, {"tokens": torch.from_numpy(toks)
                                        .long()})
    assert _err(last, want_last, dtype) <= TOL[dtype]


def _decode_both(arch, weights, steps, max_seq, dtype="float32"):
    jcfg, pcfg = _cfgs(arch, dtype)
    jp, pp = weights[arch]
    toks = _tokens(2, 2, steps, pcfg.vocab_size)
    jcache = jx_tfm.init_cache(jcfg, 2, max_seq, dtype=getattr(jnp, dtype))
    pcache = tfm.init_cache(pcfg, 2, max_seq, dtype=getattr(torch, dtype),
                            device="cpu")
    jstep = jax.jit(lambda p, t, c: jx_tfm.decode_step(jcfg, p, t, c))
    out = []
    for t in range(steps):
        want, jcache = jstep(jp, jnp.asarray(toks[:, t]), jcache)
        got, pcache = tfm.decode_step(pcfg, pp,
                                      torch.from_numpy(toks[:, t]).long(),
                                      pcache)
        out.append((got, want))
    return out, pcache, jcache


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(weights, arch, dtype):
    out, pcache, jcache = _decode_both(arch, weights, 8, 16, dtype)
    for t, (got, want) in enumerate(out):
        assert _err(got, want, dtype) <= TOL[dtype], t
    assert pcache.pos == 8 == int(jcache.pos)
    _, pcfg = _cfgs(arch)
    for seg in tfm.layer_kinds(pcfg):
        for mine, ref in zip(pcache.layers[seg], jcache.layers[seg]):
            assert tuple(mine.shape) == ref.shape
            assert _err(mine, ref, dtype) <= TOL[dtype]
            axis = 3 if arch == "grok-1-314b" else 2     # the positions
            assert not mine.narrow(axis, 8, 8).any()


def test_mla_decode_past_max_seq_clamps_as_reference(weights):
    """10 steps over a latent cache of 8 positions: steps 8 and 9 write
    slot 7 and attend over all 8 slots, in both packages."""
    out, pcache, jcache = _decode_both("deepseek-v3-671b", weights, 10, 8)
    for t, (got, want) in enumerate(out):
        assert _err(got, want, "float32") <= TOL["float32"], t
    for seg in ("dense", "moe"):
        for mine, ref in zip(pcache.layers[seg], jcache.layers[seg]):
            assert _err(mine, ref, "float32") <= TOL["float32"]


def test_f32_compute_over_a_bf16_latent_cache_raises_in_both(weights):
    jcfg, pcfg = _cfgs("deepseek-v3-671b", "float32")
    jp, pp = weights["deepseek-v3-671b"]
    with pytest.raises(TypeError):
        jx_tfm.decode_step(jcfg, jp, jnp.array([1, 2], jnp.int32),
                           jx_tfm.init_cache(jcfg, 2, 8))
    with pytest.raises(TypeError, match="cache holds torch.bfloat16"):
        tfm.decode_step(pcfg, pp, torch.tensor([1, 2]),
                        tfm.init_cache(pcfg, 2, 8, device="cpu"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_decoding_the_prompt(weights, monkeypatch, arch,
                                            dtype):
    monkeypatch.setenv("REPRO_MOE_CF", "8")
    _, pcfg = _cfgs(arch, dtype)
    pp = weights[arch][1]
    toks = torch.from_numpy(_tokens(3, 2, 40, pcfg.vocab_size)).long()
    want = tfm.prefill(pcfg, pp, tokens=toks)
    cache = tfm.init_cache(pcfg, 2, 40, dtype=getattr(torch, dtype),
                           device="cpu")
    for t in range(toks.shape[1]):
        got, cache = tfm.decode_step(pcfg, pp, toks[:, t], cache)
    assert _err(got, want.float().numpy(), dtype) <= TOL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(weights, arch):
    """Batch 2, 4 greedy steps from tokens [3, 5] over a 32-position cache,
    in f32 compute: the port's tokens are ``repro``'s step by step."""
    jp, pp = weights[arch]
    jcfg, pcfg = _cfgs(arch, "float32")
    jstep = jax.jit(lambda p, t, c: jx_make_serve_step(jcfg)(p, t, c))
    pstep = make_serve_step(pcfg)
    jcache = jx_tfm.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    pcache = tfm.init_cache(pcfg, 2, 32, dtype=torch.float32, device="cpu")
    jtok, ptok = jnp.array([3, 5], jnp.int32), torch.tensor([3, 5])
    for _ in range(4):
        jtok, _, jcache = jstep(jp, jtok, jcache)
        ptok, _, pcache = pstep(pp, ptok, pcache)
        assert ptok.tolist() == np.asarray(jtok).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_moe_on_the_cpu(capsys, arch):
    pt_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                   "--batch", "2", "--tokens", "4"])
    out = capsys.readouterr().out
    assert f"device: cpu, arch={arch}" in out and "decoded 4 x batch 2" in out
    sample = out.rsplit("sample ", 1)[1].strip()
    assert len(ast.literal_eval(sample)) == 4
