"""The port's encdec family (seamless-m4t-large-v2: a non-causal encoder over
frame embeddings, a causal decoder with cross-attention) against the JAX
package's, on the reduced config (2 encoder and 2 decoder layers, d_model
128, 4 heads of 32), from the same weights: ``repro``'s ``init_params``
converted to tensors (``repro_torch.models.convert``).

- ``forward`` with ``enc_embeds`` (S_enc 48, the stub frontend's frame
  embeddings) and decoder tokens (S_dec 16): logits and the collected
  caches (the decoder's self (k, v) and its cross (k, v) over the
  encoder's output), and ``prefill`` through ``make_prefill_step``, f32 and
  bf16, in one attention block and under ``REPRO_ATTN_CHUNK=16`` in both
  packages;
- the encoder alone (its output after ``enc_norm``), and that it is not
  causal: a change to the last frame moves the first frame's output;
- 16 ``decode_step``s whose ``enc_out`` is the forward's collected cross
  caches: logits equal to ``repro``'s and, at the last step, to the
  prefill's last logits;
- the serve launcher's cache (cross-attention over zeros, as
  ``repro.launch.serve`` makes it) in both packages, and
  ``python -m repro_torch.launch.serve --arch seamless-m4t-large-v2
  --reduced --device cpu``.

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
from repro.models import layers as jx_layers
from repro.models import transformer as jx_tfm

from repro_torch.configs import base as pt_base
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as pt_serve
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import rms_norm
from repro_torch.serve.decode import make_prefill_step, make_serve_step

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ARCH = "seamless-m4t-large-v2"
DTYPES = ["float32", "bfloat16"]
S_ENC, S_DEC = 48, 16


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


def _inputs(seed, d_model, vocab, b=2):
    """(decoder tokens [b, S_DEC] int32, frame embeddings [b, S_ENC, d])."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, S_DEC)).astype(np.int32),
            rng.standard_normal((b, S_ENC, d_model)).astype(np.float32))


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


def _both_forward(jcfg, pcfg, jp, pp, toks, frames):
    want, jcaches = jx_tfm.forward(jcfg, jp, tokens=jnp.asarray(toks),
                                   enc_embeds=jnp.asarray(frames),
                                   collect_cache=True)
    got, caches = tfm.forward(pcfg, pp, tokens=torch.from_numpy(toks).long(),
                              enc_embeds=torch.from_numpy(frames),
                              collect_cache=True)
    return (want, jcaches), (got, caches)


def test_port_init_has_the_reference_tree():
    """The encoder stack, the decoder's ``cross`` stack and ``enc_norm``,
    as the JAX package's."""
    jcfg, pcfg = _cfgs()
    want = jax.eval_shape(lambda: jx_tfm.init_params(jcfg, jax.random.key(0)))
    got = tfm.init_params(pcfg, seed=0, device="cpu")
    shapes = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
              for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    mine = {jax.tree_util.keystr(p): (tuple(v.shape),
                                      str(v.dtype).replace("torch.", ""))
            for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert mine == shapes
    assert set(got) >= {"enc", "cross", "enc_norm"}
    assert tfm.layer_kinds(pcfg) == jx_tfm.layer_kinds(jcfg)


@pytest.mark.parametrize("chunk", [None, "16"], ids=["one-block", "chunk16"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_prefill_match_reference(weights, monkeypatch, dtype,
                                             chunk):
    if chunk:
        monkeypatch.setenv("REPRO_ATTN_CHUNK", chunk)
    jcfg, pcfg = _cfgs(dtype)
    jp, pp = weights
    toks, frames = _inputs(1, pcfg.d_model, pcfg.vocab_size)
    (want, jcaches), (got, caches) = _both_forward(jcfg, pcfg, jp, pp, toks,
                                                   frames)
    assert tuple(got.shape) == (2, S_DEC, pcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    assert _err(got, want, dtype) <= TOL[dtype]
    (k, v), (ck, cv) = caches["cross"]
    (jk, jv), (jck, jcv) = jcaches["cross"]
    shape = (pcfg.n_layers, 2, pcfg.n_kv_heads, None, pcfg.head_dim)
    for mine, ref, s in ((k, jk, S_DEC), (v, jv, S_DEC), (ck, jck, S_ENC),
                         (cv, jcv, S_ENC)):
        assert tuple(mine.shape) == ref.shape == shape[:3] + (s,) + shape[4:]
        assert _err(mine, ref, dtype) <= TOL[dtype]
    last = make_prefill_step(pcfg)(pp, {"tokens": torch.from_numpy(toks),
                                        "enc_embeds":
                                            torch.from_numpy(frames)})
    assert _err(last, jx_tfm.prefill(jcfg, jp, tokens=jnp.asarray(toks),
                                     enc_embeds=jnp.asarray(frames)),
                dtype) <= TOL[dtype]


def _encode(pcfg, pp, frames):
    e, _ = tfm._scan_segment(pcfg, "dense", pp["enc"], frames,
                             causal_kind="enc")
    return rms_norm(e, pp["enc_norm"], pcfg.norm_eps)


def test_encoder_alone_matches_reference_and_is_not_causal(weights):
    jcfg, pcfg = _cfgs()
    jp, pp = weights
    _, frames = _inputs(2, pcfg.d_model, pcfg.vocab_size)
    e, _ = jx_tfm._scan_segment(jcfg, "dense", jp["enc"], jnp.asarray(frames),
                                causal_kind="enc")
    want = jx_layers.rms_norm(e, jp["enc_norm"], jcfg.norm_eps)
    got = _encode(pcfg, pp, torch.from_numpy(frames))
    assert _err(got, want, "float32") <= TOL["float32"]
    moved = frames.copy()
    moved[:, -1] += 1.0
    got2 = _encode(pcfg, pp, torch.from_numpy(moved))
    assert (got2[:, 0] - got[:, 0]).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_over_the_forwards_cross_caches(weights, dtype):
    """16 decode steps from ``init_cache`` with ``enc_out`` = the forward's
    collected cross caches (each package its own): every step's logits
    against ``repro``'s, and the last against the prefill's."""
    jcfg, pcfg = _cfgs(dtype)
    jp, pp = weights
    toks, frames = _inputs(3, pcfg.d_model, pcfg.vocab_size)
    (want_all, jcaches), (got_all, caches) = _both_forward(
        jcfg, pcfg, jp, pp, toks, frames)
    jcache = jx_tfm.init_cache(jcfg, 2, 32, dtype=getattr(jnp, dtype),
                               enc_out=jcaches["cross"][1])
    pcache = tfm.init_cache(pcfg, 2, 32, dtype=getattr(torch, dtype),
                            enc_out=caches["cross"][1], device="cpu")
    jstep = jax.jit(lambda p, t, c: jx_tfm.decode_step(jcfg, p, t, c))
    step = make_serve_step(pcfg)
    for t in range(S_DEC):
        want, jcache = jstep(jp, jnp.asarray(toks[:, t]), jcache)
        nxt, got, pcache = step(pp, torch.from_numpy(toks[:, t]).long(),
                                pcache)
        assert _err(got, want, dtype) <= TOL[dtype], t
        assert torch.equal(nxt, got.float().argmax(-1))
    assert pcache.pos == S_DEC == int(jcache.pos)
    assert _err(got, got_all[:, -1].float().numpy(), dtype) <= TOL[dtype]
    for mine, ref in zip(pcache.layers["cross_self"],
                         jcache.layers["cross_self"]):
        assert _err(mine[:, :, :, :S_DEC], np.asarray(ref)[:, :, :, :S_DEC],
                    dtype) <= TOL[dtype]
        assert not mine[:, :, :, S_DEC:].any()


def test_launcher_cache_of_zeros_matches_reference(weights):
    """The serve launchers' cache: cross-attention over zeros [L, B, Hkv,
    max_seq, hd] (there is no encoder pass), 4 greedy steps from tokens [3,
    5], in f32 compute, tokens and logits as ``repro``'s."""
    jcfg, pcfg = _cfgs()
    jp, pp = weights
    shape = (pcfg.n_layers, 2, pcfg.n_kv_heads, 32, pcfg.head_dim)
    jcache = jx_tfm.init_cache(
        jcfg, 2, 32, dtype=jnp.float32,
        enc_out=tuple(jnp.zeros(shape, jnp.float32) for _ in range(2)))
    pcache = tfm.init_cache(
        pcfg, 2, 32, dtype=torch.float32,
        enc_out=tuple(torch.zeros(shape) for _ in range(2)), device="cpu")
    jtok, ptok = jnp.array([3, 5], jnp.int32), torch.tensor([3, 5])
    for _ in range(4):
        want, jcache = jx_tfm.decode_step(jcfg, jp, jtok, jcache)
        got, pcache = tfm.decode_step(pcfg, pp, ptok, pcache)
        assert _err(got, want, "float32") <= TOL["float32"]
        jtok = jnp.argmax(want, -1).astype(jnp.int32)
        ptok = got.argmax(-1)
        assert ptok.tolist() == np.asarray(jtok).tolist()


def test_serve_launcher_runs_encdec_on_the_cpu(capsys):
    pt_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                   "--batch", "2", "--tokens", "4"])
    out = capsys.readouterr().out
    assert f"device: cpu, arch={ARCH}" in out and "decoded 4 x batch 2" in out
    sample = out.rsplit("sample ", 1)[1].strip()
    assert len(ast.literal_eval(sample)) == 4
