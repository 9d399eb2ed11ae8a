"""The port's vlm family (llava-next-34b: dense GQA blocks fed the stub
frontend's patch embeddings) against the JAX package's, on the reduced
config (2 layers, d_model 128, 4 q heads over 2 KV heads of 32), from the
same weights: ``repro``'s ``init_params`` converted to tensors
(``repro_torch.models.convert``).

- ``forward`` from ``embeds`` (logits and the collected (k, v) caches) and
  ``prefill`` through ``make_prefill_step``, f32 and bf16, in one attention
  block and under ``REPRO_ATTN_CHUNK=16`` in both packages;
- 8 ``decode_step``s fed embeddings, logits and the written cache;
- prefill of embeddings equals feeding them through ``decode_step``;
- greedy tokens equal to ``repro``'s;
- ``python -m repro_torch.launch.serve --arch llava-next-34b --reduced
  --device cpu`` runs.

Tolerances, as in ``tests/test_torch_dense.py``: f32 max|port - repro| /
max|repro| <= 1e-4 (the same f32 function with sums in other orders);
bf16 mean|port - repro| / mean|repro| <= 3e-2 (PyTorch and XLA round bf16
at other places; a wrong layer gives differences of order 1). Inputs come
from numpy with a seed.
"""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jx_base
from repro.configs.registry import get_config as jx_get_config
from repro.models import transformer as jx_tfm
from repro.serve.decode import make_serve_step as jx_make_serve_step

from repro_torch.configs import base as pt_base
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as pt_serve
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_reference
from repro_torch.serve.decode import make_prefill_step, make_serve_step

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ARCH = "llava-next-34b"
DTYPES = ["float32", "bfloat16"]


def _cfgs(compute_dtype="float32"):
    return (jx_base.reduced(jx_get_config(ARCH), compute_dtype=compute_dtype),
            pt_base.reduced(get_config(ARCH), compute_dtype=compute_dtype))


@pytest.fixture(scope="module")
def weights():
    """``repro``'s parameters (seed 0) and their conversion."""
    jcfg, _ = _cfgs()
    jp = jx_tfm.init_params(jcfg, jax.random.key(0))
    return jp, params_from_reference(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _embeds(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _err(got, want, dtype):
    """The module's measure: max-normalized in f32, mean-normalized in
    bf16."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    diff = np.abs(got - want)
    if dtype == "float32":
        return float(diff.max() / np.abs(want).max())
    return float(diff.mean() / np.abs(want).mean())


def test_port_init_has_the_reference_tree():
    jcfg, pcfg = _cfgs()
    want = jax.eval_shape(lambda: jx_tfm.init_params(jcfg, jax.random.key(0)))
    got = tfm.init_params(pcfg, seed=0, device="cpu")
    shapes = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
              for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    mine = {jax.tree_util.keystr(p): (tuple(v.shape),
                                      str(v.dtype).replace("torch.", ""))
            for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert mine == shapes
    assert tfm.layer_kinds(pcfg) == jx_tfm.layer_kinds(jcfg) == {
        "dense": pcfg.n_layers}


@pytest.mark.parametrize("chunk", [None, "16"], ids=["one-block", "chunk16"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_prefill_from_embeds_match_reference(
        weights, monkeypatch, dtype, chunk):
    if chunk:
        monkeypatch.setenv("REPRO_ATTN_CHUNK", chunk)
    jcfg, pcfg = _cfgs(dtype)
    jp, pp = weights
    emb = _embeds(1, 2, 64, pcfg.d_model)
    want, jcaches = jx_tfm.forward(jcfg, jp, embeds=jnp.asarray(emb),
                                   collect_cache=True)
    got, caches = tfm.forward(pcfg, pp, embeds=torch.from_numpy(emb),
                              collect_cache=True)
    assert tuple(got.shape) == (2, 64, pcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    assert _err(got, want, dtype) <= TOL[dtype]
    for mine, ref in zip(caches["dense"], jcaches["dense"]):
        assert tuple(mine.shape) == ref.shape == (
            pcfg.n_layers, 2, pcfg.n_kv_heads, 64, pcfg.head_dim)
        assert _err(mine, ref, dtype) <= TOL[dtype]
    last = make_prefill_step(pcfg)(pp, {"embeds": torch.from_numpy(emb)})
    assert _err(last, jx_tfm.prefill(jcfg, jp, embeds=jnp.asarray(emb)),
                dtype) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_from_embeds_match_reference(weights, dtype):
    jcfg, pcfg = _cfgs(dtype)
    jp, pp = weights
    emb = _embeds(2, 2, 8, pcfg.d_model)
    jcache = jx_tfm.init_cache(jcfg, 2, 16, dtype=getattr(jnp, dtype))
    pcache = tfm.init_cache(pcfg, 2, 16, dtype=getattr(torch, dtype),
                            device="cpu")
    for t in range(8):
        want, jcache = jx_tfm.decode_step(jcfg, jp, jnp.asarray(emb[:, t]),
                                          jcache)
        got, pcache = tfm.decode_step(pcfg, pp, torch.from_numpy(emb[:, t]),
                                      pcache)
        assert _err(got, want, dtype) <= TOL[dtype], t
    assert pcache.pos == 8 == int(jcache.pos)
    for mine, ref in zip(pcache.layers["dense"], jcache.layers["dense"]):
        assert _err(mine[:, :, :, :8], np.asarray(ref)[:, :, :, :8],
                    dtype) <= TOL[dtype]
        assert not mine[:, :, :, 8:].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_equals_decoding_the_embeds(weights, dtype):
    _, pcfg = _cfgs(dtype)
    pp = weights[1]
    emb = torch.from_numpy(_embeds(3, 2, 40, pcfg.d_model))
    want = tfm.prefill(pcfg, pp, embeds=emb)
    cache = tfm.init_cache(pcfg, 2, 40, dtype=getattr(torch, dtype),
                           device="cpu")
    for t in range(emb.shape[1]):
        got, cache = tfm.decode_step(pcfg, pp, emb[:, t], cache)
    assert _err(got, want.float().numpy(), dtype) <= TOL[dtype]


def test_greedy_tokens_match_reference(weights):
    """Batch 2, 4 greedy steps from tokens [3, 5] over a 32-position cache,
    in f32 compute: the port's tokens are ``repro``'s step by step."""
    jp, pp = weights
    jcfg, pcfg = _cfgs("float32")
    jstep = jax.jit(lambda p, t, c: jx_make_serve_step(jcfg)(p, t, c))
    pstep = make_serve_step(pcfg)
    jcache = jx_tfm.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    pcache = tfm.init_cache(pcfg, 2, 32, dtype=torch.float32, device="cpu")
    jtok, ptok = jnp.array([3, 5], jnp.int32), torch.tensor([3, 5])
    for _ in range(4):
        jtok, _, jcache = jstep(jp, jtok, jcache)
        ptok, _, pcache = pstep(pp, ptok, pcache)
        assert ptok.tolist() == np.asarray(jtok).tolist()


def test_serve_launcher_runs_vlm_on_the_cpu(capsys):
    pt_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                   "--batch", "2", "--tokens", "4"])
    out = capsys.readouterr().out
    assert f"device: cpu, arch={ARCH}" in out and "decoded 4 x batch 2" in out
    sample = out.rsplit("sample ", 1)[1].strip()
    assert len(ast.literal_eval(sample)) == 4
