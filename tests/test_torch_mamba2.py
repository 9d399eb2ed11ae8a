"""The port's mamba2-1.3b against the JAX package's, on the reduced config
(2 layers, d_model 128, d_state 16), from the same weights: ``repro``'s
``init_params`` converted to tensors (``repro_torch.models.convert``).

- ``forward`` logits, ``prefill`` and 8 ``decode_step``s from
  ``init_cache``, at compute dtype f32 and bf16, with S = 64 (one SSD
  chunk) and S = 200 (no tiling by 128: both packages then take the token
  recurrence on the CPU);
- prefill of a prompt equals feeding the prompt through ``decode_step``;
- the own copies of ``repro.configs`` equal the originals, and every arch
  of the registry inits its parameters and decode cache, reduced, with the
  reference's tree and cache shapes;
- ``python -m repro_torch.launch.serve --reduced --device cpu`` runs.

Tolerances. f32: max|port - repro| / max|repro| <= 1e-4 — both compute
the same f32 function with products and sums in other orders (and the
chunked SSD against the Pallas interpret path), a few ulp per operation
over two layers, far below 1e-4. bf16: mean|port - repro| / mean|repro| <=
3e-2 — each package's bf16 logits lie about 1.7e-2 (mean) and 6e-2 (max)
from its f32 logits on this config, because PyTorch and XLA round bf16
products and sums at other places and a flipped rounding (2^-8 relative)
travels through the norms; two such paths differ by about as much, so the
mean is the stable measure and 3e-2 holds it with margin while a wrong
layer still shows (differences of order 1). Inputs come from numpy with a
seed.
"""

import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jx_base
from repro.configs.registry import all_archs as jx_all_archs
from repro.configs.registry import get_config as jx_get_config
from repro.models import transformer as jx_tfm

from repro_torch.configs import base as pt_base
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.launch import serve as pt_serve
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_reference, to_tensor
from repro_torch.serve.decode import make_prefill_step, make_serve_step

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ARCH = "mamba2-1.3b"


def _cfgs(compute_dtype):
    return (jx_base.reduced(jx_get_config(ARCH), compute_dtype=compute_dtype),
            pt_base.reduced(get_config(ARCH), compute_dtype=compute_dtype))


@pytest.fixture(scope="module")
def weights():
    """``repro``'s parameters (seed 0) and their conversion."""
    jcfg, _ = _cfgs("float32")
    jp = jx_tfm.init_params(jcfg, jax.random.key(0))
    return jp, params_from_reference(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _err(got, want, dtype):
    """The module's measure: max-normalized in f32, mean-normalized in
    bf16."""
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    want = np.abs(np.asarray(want, np.float32))
    if dtype == "float32":
        return float(diff.max() / want.max())
    return float(diff.mean() / want.mean())


def _pt(x):
    return x.float().numpy()


@pytest.mark.parametrize("arch", jx_all_archs())
def test_configs_are_equal_copies(arch):
    assert all_archs() == jx_all_archs()
    jc, pc = jx_get_config(arch), get_config(arch)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(pt_base.reduced(pc, compute_dtype="float32")) \
        == dataclasses.asdict(jx_base.reduced(jc, compute_dtype="float32"))
    assert [dataclasses.asdict(c) for c in pt_base.shapes_for(pc)] == \
        [dataclasses.asdict(c) for c in jx_base.shapes_for(jc)]
    assert pc.n_params() == jc.n_params()


def test_convert_keeps_tree_and_bits(weights):
    jp, pp = weights
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        t = pp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    bf = np.asarray(jnp.asarray([1.0, -2.5, 3.1415927], jnp.bfloat16))
    t = to_tensor(bf, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), bf.astype(np.float32))


def test_port_init_has_the_reference_tree():
    jcfg, pcfg = _cfgs("float32")
    want = jax.eval_shape(lambda: jx_tfm.init_params(jcfg, jax.random.key(0)))
    got = tfm.init_params(pcfg, seed=0, device="cpu")
    shapes = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
              for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    mine = {jax.tree_util.keystr(p): (tuple(v.shape),
                                      str(v.dtype).replace("torch.", ""))
            for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert mine == shapes
    mamba = got["ssm"]["mamba"]
    assert not mamba["conv_b"].any() and not mamba["a_log"].any()
    assert not mamba["dt_bias"].any()


@pytest.mark.parametrize("seq", [64, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match_reference(weights, dtype, seq):
    jcfg, pcfg = _cfgs(dtype)
    jp, pp = weights
    toks = _tokens(1, 2, seq, pcfg.vocab_size)
    want, _ = jx_tfm.forward(jcfg, jp, tokens=jnp.asarray(toks))
    got, caches = tfm.forward(pcfg, pp, tokens=torch.from_numpy(toks).long())
    assert caches is None and tuple(got.shape) == (2, seq, pcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    assert _err(_pt(got), want, dtype) <= TOL[dtype]
    last = make_prefill_step(pcfg)(pp, {"tokens": torch.from_numpy(toks)})
    assert _err(_pt(last), jx_tfm.prefill(jcfg, jp, tokens=jnp.asarray(
        toks)), dtype) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(weights, dtype):
    jcfg, pcfg = _cfgs(dtype)
    jp, pp = weights
    toks = _tokens(2, 2, 8, pcfg.vocab_size)
    cache_dtype = getattr(jnp, dtype)
    jcache = jx_tfm.init_cache(jcfg, 2, 16, dtype=cache_dtype)
    pcache = tfm.init_cache(pcfg, 2, 16, dtype=getattr(torch, dtype),
                            device="cpu")
    step = make_serve_step(pcfg)
    for t in range(8):
        want, jcache = jx_tfm.decode_step(jcfg, jp, jnp.asarray(toks[:, t]),
                                          jcache)
        nxt, got, pcache = step(pp, torch.from_numpy(toks[:, t]).long(),
                                pcache)
        assert _err(_pt(got), want, dtype) <= TOL[dtype], t
        assert torch.equal(nxt, got.float().argmax(-1))
    assert pcache.pos == 8 == int(jcache.pos)
    assert _err(pcache.layers["ssm"].ssm.numpy(),
                np.asarray(jcache.layers["ssm"][1]), dtype) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_equals_decoding_the_prompt(weights, dtype):
    """The model's invariant: the last logits of a prompt's forward are the
    logits after feeding the prompt token by token through the O(1)-state
    decode step (chunked SSD against its recurrence)."""
    _, pcfg = _cfgs(dtype)
    pp = weights[1]
    toks = torch.from_numpy(_tokens(3, 2, 48, pcfg.vocab_size)).long()
    want = tfm.prefill(pcfg, pp, tokens=toks)
    cache = tfm.init_cache(pcfg, 2, 48, dtype=getattr(torch, dtype),
                           device="cpu")
    for t in range(toks.shape[1]):
        got, cache = tfm.decode_step(pcfg, pp, toks[:, t], cache)
    assert _err(_pt(got), _pt(want), dtype) <= TOL[dtype]


def _shapes(tree):
    """The leaves' shapes of a cache tree (dicts by sorted key, as JAX
    flattens them; None left out)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _shapes(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [s for t in tree for s in _shapes(t)]
    return [tuple(tree.shape)]


@pytest.mark.parametrize("arch", all_archs())
def test_every_arch_inits_and_builds_a_cache(arch):
    """Every arch of the port's registry, reduced, inits its parameters and
    its decode cache on the CPU, with the reference's parameter tree and
    cache shapes."""
    jcfg = jx_base.reduced(jx_get_config(arch))
    cfg = pt_base.reduced(get_config(arch))
    params = tfm.init_params(cfg, device="cpu")
    want = jax.eval_shape(lambda: jx_tfm.init_params(jcfg,
                                                     jax.random.key(0)))
    assert ({jax.tree_util.keystr(p): tuple(v.shape) for p, v in
             jax.tree_util.tree_flatten_with_path(params)[0]}
            == {jax.tree_util.keystr(p): v.shape for p, v in
                jax.tree_util.tree_flatten_with_path(want)[0]})
    cache = tfm.init_cache(cfg, 2, 16, device="cpu")
    assert cache.pos == 0
    ref = jax.eval_shape(lambda: jx_tfm.init_cache(jcfg, 2, 16))
    assert _shapes(cache.layers) == _shapes(ref.layers) != []


def test_serve_launcher_runs_on_the_cpu(capsys):
    pt_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                   "--batch", "2", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "decoded 4 x batch 2" in out
    sample = out.rsplit("sample ", 1)[1].strip()
    assert len(ast.literal_eval(sample)) == 4
