"""The port's hybrid family (zamba2-1.2b: a Mamba-2 backbone with one shared
attention block between its segments, sliding window) against the JAX
package's, on the reduced config (4 layers, the shared block after every 2,
d_model 128, d_state 16) with ``sliding_window`` 16 in both packages (the
reduced config keeps the full 4 096, which no CPU-sized sequence reaches),
from the same weights: ``repro``'s ``init_params`` converted to tensors
(``repro_torch.models.convert``). A 5-layer variant (segments 2, 2, 1: two
shared sites, the last segment short, as zamba2's 38 layers over 6) runs
too, in f32.

- ``forward`` logits and its collected caches (the shared sites' (k, v)),
  and ``prefill``, at S = 64 (one attention block) and under
  ``REPRO_ATTN_CHUNK=16`` in both packages (the windowed multi-chunk online
  softmax), f32 and bf16;
- 40 ``decode_step``s from ``init_cache`` (a ring of 16 slots per site,
  wrapped twice): logits and the ring's contents;
- prefill of a 40-token prompt equals feeding it through ``decode_step``;
- greedy tokens equal to ``repro``'s (the counterpart of
  ``tests/test_train_integration.py::test_serve_greedy_decode`` for
  zamba2-1.2b);
- ``python -m repro_torch.launch.serve --arch zamba2-1.2b --reduced
  --device cpu`` runs.

Tolerances. f32: max|port - repro| / max|repro| <= 1e-4, as in
``tests/test_torch_mamba2.py`` — the same f32 function with products and
sums in other orders (measured: 4e-6 to 9e-6 on the logits). bf16:
mean|port - repro| / mean|repro| <= 6e-2, not the 3e-2 of the dense and
ssm tests: PyTorch and XLA round bf16 products, sums and activations at
other places, and a flipped rounding (2^-8 relative) travels through the
norms, which the Mamba-2 layers amplify (and in decode through the bf16
states). On the 4-layer config each package's bf16 logits lie up to
3.5e-2 (forward, three seeds of tokens) and 4.9e-2 (40 decode steps)
(mean) from the f32 function, the port's no further than the
reference's, and the two bf16 paths differ by up to 3.3e-2 and 4.8e-2;
6e-2 holds that while a wrong layer still shows (differences of order
1). The 5-layer variant amplifies more (the reference's own bf16 decode
drifts 8.0e-2 from its f32), so it is compared in f32 only: the structure
it adds does not depend on the dtype. Inputs come from numpy with a seed.
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
from repro.models import transformer as jx_tfm
from repro.serve.decode import make_serve_step as jx_make_serve_step

from repro_torch.configs import base as pt_base
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as pt_serve
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_reference
from repro_torch.serve.decode import make_prefill_step, make_serve_step

TOL = {"float32": 1e-4, "bfloat16": 6e-2}
ARCH = "zamba2-1.2b"
WINDOW = 16
DTYPES = ["float32", "bfloat16"]
LAYERS = [4, 5]
# (dtype, layers): the 5-layer variant in f32 only (see above)
CASES = [("float32", 4), ("bfloat16", 4), ("float32", 5)]


def _cfgs(compute_dtype="float32", n_layers=4):
    kw = dict(compute_dtype=compute_dtype, sliding_window=WINDOW,
              n_layers=n_layers)
    return (jx_base.reduced(jx_get_config(ARCH), **kw),
            pt_base.reduced(get_config(ARCH), **kw))


@pytest.fixture(scope="module")
def weights():
    """Per depth, ``repro``'s parameters (seed 0) and their conversion."""
    out = {}
    for n in LAYERS:
        jcfg, _ = _cfgs(n_layers=n)
        jp = jx_tfm.init_params(jcfg, jax.random.key(0))
        out[n] = (jp, params_from_reference(jax.tree.map(np.asarray, jp),
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


def test_port_init_has_the_reference_tree():
    """The Mamba-2 stack, the unstacked ``shared`` block, and the layer
    segments, as the JAX package's."""
    jcfg, pcfg = _cfgs()
    want = jax.eval_shape(lambda: jx_tfm.init_params(jcfg, jax.random.key(0)))
    got = tfm.init_params(pcfg, seed=0, device="cpu")
    shapes = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
              for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    mine = {jax.tree_util.keystr(p): (tuple(v.shape),
                                      str(v.dtype).replace("torch.", ""))
            for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert mine == shapes
    assert got["shared"]["attn"]["wq"].dim() == 2
    assert tfm.layer_kinds(pcfg) == jx_tfm.layer_kinds(jcfg)
    for n in (4, 5, 38):
        _, cfg = _cfgs(n_layers=n)
        assert tfm._hybrid_segments(cfg) == jx_tfm._hybrid_segments(cfg)


@pytest.mark.parametrize("chunk", [None, "16"], ids=["one-block", "chunk16"])
@pytest.mark.parametrize("dtype,n_layers", CASES)
def test_forward_and_prefill_match_reference(weights, monkeypatch, dtype,
                                             chunk, n_layers):
    if chunk:
        monkeypatch.setenv("REPRO_ATTN_CHUNK", chunk)
    jcfg, pcfg = _cfgs(dtype, n_layers)
    jp, pp = weights[n_layers]
    toks = _tokens(1, 2, 64, pcfg.vocab_size)
    want, jcaches = jx_tfm.forward(jcfg, jp, tokens=jnp.asarray(toks),
                                   collect_cache=True)
    got, caches = tfm.forward(pcfg, pp, tokens=torch.from_numpy(toks).long(),
                              collect_cache=True)
    assert tuple(got.shape) == (2, 64, pcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    assert _err(got, want, dtype) <= TOL[dtype]
    sites = len(tfm._hybrid_segments(pcfg)) - 1
    assert caches["ssm"] == [] == jcaches["ssm"]
    assert len(caches["shared_kv"]) == sites == len(jcaches["shared_kv"])
    for mine, ref in zip(caches["shared_kv"], jcaches["shared_kv"]):
        for m, r in zip(mine, ref):
            assert tuple(m.shape) == r.shape == (
                2, pcfg.n_kv_heads, 64, pcfg.head_dim)
            assert _err(m, r, dtype) <= TOL[dtype]
    assert tfm.forward(pcfg, pp, tokens=torch.from_numpy(toks).long())[1] \
        is None
    last = make_prefill_step(pcfg)(pp, {"tokens": torch.from_numpy(toks)})
    assert _err(last, jx_tfm.prefill(jcfg, jp, tokens=jnp.asarray(toks)),
                dtype) <= TOL[dtype]


@pytest.mark.parametrize("dtype,n_layers", CASES)
def test_decode_steps_wrap_the_ring_as_reference(weights, dtype, n_layers):
    """40 steps at max_seq 64: each shared site's cache is a ring of
    min(64, 16) = 16 slots, written at pos % 16, so it wraps twice; logits
    every step, and the ring and the Mamba-2 states at the end."""
    jcfg, pcfg = _cfgs(dtype, n_layers)
    jp, pp = weights[n_layers]
    toks = _tokens(2, 2, 40, pcfg.vocab_size)
    jcache = jx_tfm.init_cache(jcfg, 2, 64, dtype=getattr(jnp, dtype))
    pcache = tfm.init_cache(pcfg, 2, 64, dtype=getattr(torch, dtype),
                            device="cpu")
    sites = len(tfm._hybrid_segments(pcfg)) - 1
    assert tuple(pcache.layers["shared_kv"][0].shape) == (
        sites, 2, pcfg.n_kv_heads, WINDOW, pcfg.head_dim)
    jstep = jax.jit(lambda p, t, c: jx_tfm.decode_step(jcfg, p, t, c))
    step = make_serve_step(pcfg)
    for t in range(40):
        want, jcache = jstep(jp, jnp.asarray(toks[:, t]), jcache)
        nxt, got, pcache = step(pp, torch.from_numpy(toks[:, t]).long(),
                                pcache)
        assert _err(got, want, dtype) <= TOL[dtype], t
        assert torch.equal(nxt, got.float().argmax(-1))
    assert pcache.pos == 40 == int(jcache.pos)
    for mine, ref in zip(pcache.layers["shared_kv"],
                         jcache.layers["shared_kv"]):
        assert mine.dtype == getattr(torch, dtype)
        assert _err(mine, ref, dtype) <= TOL[dtype]
    assert _err(pcache.layers["ssm"].ssm, jcache.layers["ssm"][1],
                dtype) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_equals_decoding_the_prompt(weights, dtype):
    """The model's invariant: the last logits of a 40-token prompt's
    forward (windowed attention over all 40 keys) are the logits after
    feeding the prompt token by token through the decode step (the Mamba-2
    recurrence, and the shared block over its 16-slot ring)."""
    _, pcfg = _cfgs(dtype)
    pp = weights[4][1]
    toks = torch.from_numpy(_tokens(3, 2, 40, pcfg.vocab_size)).long()
    want = tfm.prefill(pcfg, pp, tokens=toks)
    cache = tfm.init_cache(pcfg, 2, 40, dtype=getattr(torch, dtype),
                           device="cpu")
    for t in range(toks.shape[1]):
        got, cache = tfm.decode_step(pcfg, pp, toks[:, t], cache)
    assert _err(got, want.float().numpy(), dtype) <= TOL[dtype]


def test_window_changes_the_prefill():
    """The window binds: at S = 64 a window of 16 gives other logits than
    no window (so the parity tests above see it)."""
    _, pcfg = _cfgs()
    params = tfm.init_params(pcfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(6, 1, 64, pcfg.vocab_size)).long()
    windowed = tfm.prefill(pcfg, params, tokens=toks)
    wide = tfm.prefill(dataclasses.replace(pcfg, sliding_window=0), params,
                       tokens=toks)
    assert _err(windowed, wide.numpy(), "float32") > 1e-3


def test_greedy_tokens_match_reference(weights):
    """The reference's serving check for zamba2-1.2b (reduced; batch 2, 4
    greedy steps from tokens [3, 5], a 32-position cache, here with window
    16 so the ring is 16 slots), with the converted weights in both
    packages and the tokens compared. f32 compute: equal step by step.
    bf16: each step is fed the reference's token, and the port's logit at
    the reference's token must lie within the bf16 tolerance (6e-2 of the
    mean |logit|) of the port's largest, since the two packages' bf16
    logits differ by that much (argmax may pick the other of two such
    near-ties)."""
    jp, pp = weights[4]
    for dtype in DTYPES:
        jcfg, pcfg = _cfgs(dtype)
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
            assert bool(torch.isfinite(logits.float()).all())
            if dtype == "float32":
                assert ptok.tolist() == want
                continue
            logits = logits.float()
            at_ref = logits[torch.arange(2), torch.tensor(want)]
            assert bool((logits.amax(-1) - at_ref <= TOL["bfloat16"]
                         * logits.abs().mean(-1)).all())
            ptok = torch.tensor(want)
        assert pcache.pos == 4 == int(jcache.pos)


def test_serve_launcher_runs_hybrid_on_the_cpu(capsys):
    pt_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                   "--batch", "2", "--tokens", "4"])
    out = capsys.readouterr().out
    assert f"device: cpu, arch={ARCH}" in out and "decoded 4 x batch 2" in out
    sample = out.rsplit("sample ", 1)[1].strip()
    assert len(ast.literal_eval(sample)) == 4
