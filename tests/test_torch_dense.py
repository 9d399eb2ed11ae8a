"""The port's dense family against the JAX package's, on the reduced
yi-6b (GQA, SwiGLU), qwen3-14b (qk_norm) and starcoder2-3b (GELU MLP, two KV
heads), from the same weights: ``repro``'s ``init_params`` converted to
tensors (``repro_torch.models.convert``).

- ``forward`` logits and its collected (k, v) caches, and ``prefill``, at
  compute dtype f32 and bf16, with S = 64 (one attention block) and with
  S = 64 under ``REPRO_ATTN_CHUNK=16`` in both packages (the multi-chunk
  online softmax);
- 8 ``decode_step``s from ``init_cache``, logits and the written cache;
- prefill of a prompt equals feeding it through ``decode_step``;
- a cache with replicated KV heads (``kv_head_pad=2``), 10 steps at
  ``max_seq`` 8 (the write past the end lands on the last slot, as
  ``repro``'s update clamps it), and f32 compute over a bf16 cache (a
  ``TypeError`` in both packages);
- greedy tokens equal to ``repro``'s (the counterpart of
  ``tests/test_train_integration.py::test_serve_greedy_decode``);
- ``chunked_attention`` itself (causal, full, windowed, one and several
  chunks) against ``repro``'s;
- ``python -m repro_torch.launch.serve --arch yi-6b --reduced --device cpu``
  runs.

Tolerances, as in ``tests/test_torch_mamba2.py``. f32: max|port - repro| /
max|repro| <= 1e-4 — the same f32 function with products and sums in other
orders, a few ulp per operation over two layers. bf16: mean|port - repro| /
mean|repro| <= 3e-2 — PyTorch and XLA round bf16 products, sums and
activations at other places, and a flipped rounding (2^-8 relative) travels
through the norms; the mean is the stable measure and 3e-2 holds it with
margin while a wrong layer still shows (differences of order 1). Inputs
come from numpy with a seed.
"""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jx_base
from repro.configs.registry import get_config as jx_get_config
from repro.models import attention as jx_attention
from repro.models import transformer as jx_tfm
from repro.serve.decode import make_serve_step as jx_make_serve_step

from repro_torch.configs import base as pt_base
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as pt_serve
from repro_torch.models import attention
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_reference
from repro_torch.serve.decode import make_prefill_step, make_serve_step

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ARCHS = ["yi-6b", "qwen3-14b", "starcoder2-3b"]
DTYPES = ["float32", "bfloat16"]


def _cfgs(arch, compute_dtype="float32"):
    return (jx_base.reduced(jx_get_config(arch), compute_dtype=compute_dtype),
            pt_base.reduced(get_config(arch), compute_dtype=compute_dtype))


@pytest.fixture(scope="module")
def weights():
    """Per arch, ``repro``'s parameters (seed 0) and their conversion, made
    once for the module."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch)
        jp = jx_tfm.init_params(jcfg, jax.random.key(0))
        out[arch] = (jp, params_from_reference(jax.tree.map(np.asarray, jp),
                                               device="cpu"))
    return out


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


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
    want, jcaches = jx_tfm.forward(jcfg, jp, tokens=jnp.asarray(toks),
                                   collect_cache=True)
    got, caches = tfm.forward(pcfg, pp, tokens=torch.from_numpy(toks).long(),
                              collect_cache=True)
    assert tuple(got.shape) == (2, 64, pcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    assert _err(got, want, dtype) <= TOL[dtype]
    for mine, ref in zip(caches["dense"], jcaches["dense"]):
        assert tuple(mine.shape) == ref.shape == (
            pcfg.n_layers, 2, pcfg.n_kv_heads, 64, pcfg.head_dim)
        assert _err(mine, ref, dtype) <= TOL[dtype]
    assert tfm.forward(pcfg, pp, tokens=torch.from_numpy(toks).long())[1] \
        is None
    last = make_prefill_step(pcfg)(pp, {"tokens": torch.from_numpy(toks)})
    assert _err(last, jx_tfm.prefill(jcfg, jp, tokens=jnp.asarray(toks)),
                dtype) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(weights, arch, dtype):
    jcfg, pcfg = _cfgs(arch, dtype)
    jp, pp = weights[arch]
    toks = _tokens(2, 2, 8, pcfg.vocab_size)
    jcache = jx_tfm.init_cache(jcfg, 2, 16, dtype=getattr(jnp, dtype))
    pcache = tfm.init_cache(pcfg, 2, 16, dtype=getattr(torch, dtype),
                            device="cpu")
    step = make_serve_step(pcfg)
    for t in range(8):
        want, jcache = jx_tfm.decode_step(jcfg, jp, jnp.asarray(toks[:, t]),
                                          jcache)
        nxt, got, pcache = step(pp, torch.from_numpy(toks[:, t]).long(),
                                pcache)
        assert _err(got, want, dtype) <= TOL[dtype], t
        assert torch.equal(nxt, got.float().argmax(-1))
    assert pcache.pos == 8 == int(jcache.pos)
    for mine, ref in zip(pcache.layers["dense"], jcache.layers["dense"]):
        assert mine.dtype == getattr(torch, dtype)
        assert _err(mine[:, :, :, :8], np.asarray(ref)[:, :, :, :8],
                    dtype) <= TOL[dtype]
        assert not mine[:, :, :, 8:].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_equals_decoding_the_prompt(weights, dtype):
    """The model's invariant: the last logits of a prompt's forward are the
    logits after feeding the prompt token by token through the cached
    decode step (chunked attention against decode attention)."""
    _, pcfg = _cfgs("yi-6b", dtype)
    pp = weights["yi-6b"][1]
    toks = torch.from_numpy(_tokens(3, 2, 48, pcfg.vocab_size)).long()
    want = tfm.prefill(pcfg, pp, tokens=toks)
    cache = tfm.init_cache(pcfg, 2, 48, dtype=getattr(torch, dtype),
                           device="cpu")
    for t in range(toks.shape[1]):
        got, cache = tfm.decode_step(pcfg, pp, toks[:, t], cache)
    assert _err(got, want.float().numpy(), dtype) <= TOL[dtype]


def _decode_both(arch, weights, steps, max_seq, kv_head_pad=1):
    """Logits of ``steps`` f32 decode steps in both packages, and the final
    caches."""
    jcfg, pcfg = _cfgs(arch)
    jp, pp = weights[arch]
    toks = _tokens(4, 2, steps, pcfg.vocab_size)
    jcache = jx_tfm.init_cache(jcfg, 2, max_seq, dtype=jnp.float32,
                               kv_head_pad=kv_head_pad)
    pcache = tfm.init_cache(pcfg, 2, max_seq, dtype=torch.float32,
                            device="cpu", kv_head_pad=kv_head_pad)
    out = []
    for t in range(steps):
        want, jcache = jx_tfm.decode_step(jcfg, jp, jnp.asarray(toks[:, t]),
                                          jcache)
        got, pcache = tfm.decode_step(pcfg, pp,
                                      torch.from_numpy(toks[:, t]).long(),
                                      pcache)
        out.append((got, want))
    return out, pcache, jcache


def test_kv_head_pad_matches_reference(weights):
    """yi-6b reduced has 2 KV heads for 4 q heads; a cache of 2 x 2 heads
    (each replicated) gives the reference's logits and layout."""
    out, pcache, jcache = _decode_both("yi-6b", weights, 4, 16,
                                       kv_head_pad=2)
    for got, want in out:
        assert _err(got, want, "float32") <= TOL["float32"]
    k, v = pcache.layers["dense"]
    assert k.shape[2] == 4 == jcache.layers["dense"][0].shape[2]
    np.testing.assert_array_equal(k[:, :, 0].numpy(), k[:, :, 1].numpy())
    assert _err(v, jcache.layers["dense"][1], "float32") <= TOL["float32"]


def test_decode_past_max_seq_clamps_as_reference(weights):
    """10 steps over a cache of 8 positions: steps 8 and 9 write slot 7 and
    attend over all 8 slots, in both packages."""
    out, pcache, jcache = _decode_both("yi-6b", weights, 10, 8)
    for t, (got, want) in enumerate(out):
        assert _err(got, want, "float32") <= TOL["float32"], t
    assert pcache.pos == 10 == int(jcache.pos)
    for mine, ref in zip(pcache.layers["dense"], jcache.layers["dense"]):
        assert _err(mine, ref, "float32") <= TOL["float32"]


def test_f32_compute_over_a_bf16_cache_raises_in_both(weights):
    jcfg, pcfg = _cfgs("yi-6b", "float32")
    jp, pp = weights["yi-6b"]
    with pytest.raises(TypeError):
        jx_tfm.decode_step(jcfg, jp, jnp.array([1, 2], jnp.int32),
                           jx_tfm.init_cache(jcfg, 2, 8))
    with pytest.raises(TypeError, match="cache holds torch.bfloat16"):
        tfm.decode_step(pcfg, pp, torch.tensor([1, 2]),
                        tfm.init_cache(pcfg, 2, 8, device="cpu"))


def test_greedy_tokens_match_reference(weights):
    """The reference's serving check for yi-6b (reduced; batch 2, 4 greedy
    steps from tokens [3, 5], a 32-position cache), with the converted
    weights in both packages and the tokens compared.

    In f32 compute the two packages' tokens are equal step by step. In the
    config's bf16 they may differ only at a bf16 tie: on these weights the
    reference's first step has its two top logits both at 2.609375, and
    argmax takes the first index. So in bf16 each step is fed the
    reference's token, and the port's token must be the reference's or hold
    a logit within one bf16 rounding (2^-8 relative) of the port's logit
    at the reference's token."""
    jp, pp = weights["yi-6b"]
    for dtype in ("float32", "bfloat16"):
        jcfg, pcfg = _cfgs("yi-6b", dtype)
        jstep = jax.jit(lambda p, t, c: jx_make_serve_step(jcfg)(p, t, c))
        pstep = make_serve_step(pcfg)
        jcache = jx_tfm.init_cache(jcfg, 2, 32, dtype=getattr(jnp, dtype))
        pcache = tfm.init_cache(pcfg, 2, 32, dtype=getattr(torch, dtype),
                                device="cpu")
        jtok = jnp.array([3, 5], jnp.int32)
        ptok = torch.tensor([3, 5])
        for _ in range(4):
            jtok, _, jcache = jstep(jp, jtok, jcache)
            ptok, logits, pcache = pstep(pp, ptok, pcache)
            want = np.asarray(jtok).tolist()
            if dtype == "float32":
                assert ptok.tolist() == want
                continue
            logits = logits.float()
            at_ref = logits[torch.arange(2), torch.tensor(want)]
            assert bool((logits.amax(-1) - at_ref
                         <= 2.0 ** -8 * at_ref.abs()).all())
            ptok = torch.tensor(want)


@pytest.mark.parametrize("causal,window,chunk", [
    (True, 0, 1024), (True, 0, 16), (False, 0, 16), (True, 24, 16),
    (True, 24, 1024)])
def test_chunked_attention_matches_reference(causal, window, chunk):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4, 32, 16), (2, 2, 64, 16), (2, 2, 64, 16)))
    want = jx_attention.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, chunk=chunk,
        window=window)
    got = attention.chunked_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        chunk=chunk, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # the prefill dispatch takes it on CPU tensors
    got = attention.prefill_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window)
    want = jx_attention.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_tree(arch):
    jcfg, pcfg = _cfgs(arch)
    want = jax.eval_shape(lambda: jx_tfm.init_params(jcfg, jax.random.key(0)))
    got = tfm.init_params(pcfg, seed=0, device="cpu")
    shapes = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
              for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    mine = {jax.tree_util.keystr(p): (tuple(v.shape),
                                      str(v.dtype).replace("torch.", ""))
            for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert mine == shapes
    assert tfm.layer_kinds(pcfg) == jx_tfm.layer_kinds(jcfg)


def test_serve_launcher_runs_dense_on_the_cpu(capsys):
    pt_serve.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                   "--batch", "2", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "device: cpu, arch=yi-6b" in out and "decoded 4 x batch 2" in out
    sample = out.rsplit("sample ", 1)[1].strip()
    assert len(ast.literal_eval(sample)) == 4
