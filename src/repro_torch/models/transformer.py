"""The model zoo's init / forward / prefill / decode, for every family:
dense (llama-style GQA), vlm (dense blocks fed ``embeds``), moe (GQA or
MLA attention, top-k experts after ``first_dense_layers`` dense layers),
ssm (Mamba-2), hybrid (a Mamba-2 backbone with one shared attention block
after every ``shared_attn_every`` layers, sliding window, zamba-style) and
encdec (a non-causal encoder and a causal decoder with cross-attention).

The port of ``repro.models.transformer``. Parameters are a dict of tensors
with the JAX package's tree and stacked ``[n_layers, ...]`` leaves (the
hybrid's ``shared`` block unstacked); layers run as a Python loop over
that stack. The JAX package's sharding annotations sit at its sites as
``dist.ctx.annotate`` calls, the identity: on the port's one device a
logical mesh's layout constraint has nothing to move.

Training goes through the same forward: ``lm_loss`` is the reference's
next-token loss, and under grad ``_scan_segment`` checkpoints each block
by ``cfg.remat`` and ``REPRO_REMAT`` (``full``: ``torch.utils.checkpoint``
per block; ``dots``: the projections' products saved, the rest recomputed;
``none``), as the reference's layer scan sits under ``jax.checkpoint``.
The kernels have no backward, so under grad attention and the SSD take
their plain versions (``models/attention.py``, ``kernels/ssd_scan/ops.py``),
as the reference trains.

GQA attention goes through ``prefill_attention`` and
``decode_attention_host`` (``models/attention.py``): the hand-written
kernels on CUDA tensors, the plain versions on CPU tensors. MLA (deepseek-
v3) runs as the reference runs it: prefill through ``chunked_attention``
(its q and k are 192 wide and v 128, which B2 does not take), decode in
the absorbed form over the latent cache (ckv, k_rope), einsums in f32.

On a mesh of ranks with a model axis (``dist.tensor_parallel``) every
family runs on the rank's shard of the weights and of the decode cache:
the head counts come from the local ``wq``/``wk`` (MLA: ``wq_b``; the
cross-attention's own) shapes and Mamba-2's sizes from its local weights
(``mamba2.local_sizes``), the row-parallel products (``wo``, the cross
``wo``, the FFN's and Mamba-2's ``w_out``) are all-reduced
(``row_product``), Mamba-2's gated norm sums over the group
(``group_rms_norm``), the experts are the rank's own (``moe_ffn``), the
embedding is looked up and the head's logits made whole as its layout
has them (on the vocabulary, or on d_model where the axis does not
divide the vocabulary: ``embed_lookup``, ``head_logits``,
``gather_logits``; a prefill makes its last position's whole only);
MLA's latent cache is whole on every rank, and the hybrid's ring, the
encdec's self and cross caches and the SSM states are the rank's heads.
Without one those calls are the identity. For training the replicated
activations enter the column-parallel products of the attention, the
FFN, the experts, the Mamba-2 mixer and a vocab-sharded head through
``copy_to_model`` (Megatron's f); MLA's latents, which the
whole ``wq_a`` and ``wkv_a`` give every rank, enter its heads through one
f of the three (``copy_all_to_model``; ``_mla_full``); and a data rank's
``lm_loss`` divides by the global batch's label count it is given.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..dist.ctx import act_spec, annotate
from ..dist.sharding import P
from ..dist.tensor_parallel import (copy_all_to_model, copy_to_model,
                                    embed_lookup, gather_logits,
                                    head_logits, require, row_product)
from ..kernels._build import needs_grad
from ..launch.flags import remat_policy
from .attention import (NEG_INF, chunked_attention, decode_attention_host,
                        prefill_attention)
from .layers import (apply_rope, dense_init, gelu_mlp, rms_norm, rope_freqs,
                     stacked_dense_init, swiglu, take_box)
from .mamba2 import (Mamba2State, mamba2_forward, mamba2_init_state,
                     mamba2_params_shapes, mamba2_step)
from .moe import moe_ffn, moe_params_shapes


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("float32", "bfloat16")."""
    return getattr(torch, name)


# The parameter subtrees whose products run between ``copy_to_model`` and
# a ``row_product`` (or the experts' ``sum_partials``) under tensor
# parallelism: a leaf of them that several ranks of a model line hold
# (``tensor_parallel.box_holders``: qwen3's replicated q_norm and k_norm, a
# KV head replicated kv_head_pad times, the MoE's whole router; and by
# column pieces, ``column_holders``: the B and C columns of a Mamba-2
# group whose heads the axis splits) acts on the rank's own heads or slots
# only, so its gradient on a rank is that rank's part of the whole.
TP_REGIONS = frozenset({"attn", "cross", "ffn", "moe", "mamba"})
# The leaves of those subtrees read before their f: MLA's down-projections
# and their norms, whose outputs enter the heads through
# ``copy_all_to_model`` (``_mla_full``), so their gradient is whole on
# every rank that holds them.
TP_AHEAD = frozenset({"wq_a", "q_ln", "wkv_a", "kv_ln"})


# =============================================================== parameters

def _attn_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, hd = cfg.d_model, cfg.head_dim
    if cfg.attention == "mla":
        m = cfg.mla
        return {
            "wq_a": (d, m.q_lora_rank),
            "q_ln": (m.q_lora_rank,),
            "wq_b": (m.q_lora_rank,
                     cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim)),
            "wkv_a": (d, m.kv_lora_rank + m.qk_rope_dim),
            "kv_ln": (m.kv_lora_rank,),
            "wkv_b": (m.kv_lora_rank,
                      cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)),
            "wo": (cfg.n_heads * m.v_head_dim, d),
        }
    s = {
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        s["q_norm"] = (hd,)
        s["k_norm"] = (hd,)
    return s


def _ffn_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn == "swiglu":
        return {"w_gate": (d, f), "w_in": (d, f), "w_out": (f, d)}
    return {"w_in": (d, f), "w_out": (f, d)}


def _block_shapes(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    d = cfg.d_model
    if kind == "ssm":
        return {"ln": (d,), "mamba": mamba2_params_shapes(cfg.ssm, d)}
    s: Dict[str, Any] = {"ln1": (d,), "ln2": (d,), "attn": _attn_shapes(cfg)}
    if kind == "moe":
        s["moe"] = moe_params_shapes(cfg.moe, d, cfg.ffn)
        return s
    if kind == "cross":  # encdec decoder block
        s["ln_cross"] = (d,)
        s["cross"] = _attn_shapes(cfg)
    s["ffn"] = _ffn_shapes(cfg)
    return s


def _init_tree(gen: torch.Generator, shapes, n_stack: int, dtype,
               device, shard, path) -> Any:
    """Norm weights and biases (1-D) are ones (biases are re-zeroed by
    :func:`_zero_biases`); matrices are LeCun-normal in their first axis,
    one draw per layer when stacked. Each leaf is drawn as its box
    ``shard(path, shape)`` (None: whole)."""
    if isinstance(shapes, dict):
        return {k: _init_tree(gen, v, n_stack, dtype, device, shard,
                              path + (k,))
                for k, v in shapes.items()}
    shape = (n_stack, *shapes) if n_stack else tuple(shapes)
    index = shard(path, shape)
    if len(shapes) == 1:
        leaf = torch.ones(shape, dtype=dtype, device=device)
        return leaf if index is None else take_box(leaf, index).clone()
    if n_stack:
        return stacked_dense_init(gen, n_stack, shapes, 0, dtype, device,
                                  index)
    return dense_init(gen, shapes, 0, dtype, device, index)


def _zero_biases(tree, names=("router_bias", "conv_b", "dt_bias")):
    """Zero the biases, and ``a_log`` (A = -1, a stable decay)."""
    return {k: (_zero_biases(v, names) if isinstance(v, dict)
                else torch.zeros_like(v) if k in names or k == "a_log"
                else v)
            for k, v in tree.items()}


def layer_kinds(cfg: ModelConfig) -> Dict[str, int]:
    """Named layer segments -> stack depth (the hybrid's shared attention
    block is not stacked, so not a segment). The moe family's leading
    dense layers are a segment of their own, left out when there are
    none, and so is its MoE segment (a config cut to its leading dense
    layers, deepseek-v3-671b's first 3: ``repro`` would give it an
    unstacked MoE tree, which its layer scan cannot run)."""
    if cfg.family in ("dense", "vlm"):
        return {"dense": cfg.n_layers}
    if cfg.family == "moe":
        fd = min(cfg.moe.first_dense_layers, cfg.n_layers)
        return {**({"dense": fd} if fd else {}),
                **({"moe": cfg.n_layers - fd} if cfg.n_layers > fd else {})}
    if cfg.family in ("ssm", "hybrid"):
        return {"ssm": cfg.n_layers}
    if cfg.family == "encdec":
        return {"enc": cfg.encoder_layers, "cross": cfg.n_layers}
    raise ValueError(cfg.family)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                shard=None) -> Dict[str, Any]:
    """Random parameters with the JAX package's tree, shapes and init rules,
    drawn from a generator on ``device`` seeded with ``seed``. The numbers
    differ from ``repro``'s ``init_params``; to compute the same function as
    ``repro``, convert its parameters with :mod:`repro_torch.models.convert`.
    On the ``meta`` device nothing is drawn or allocated
    (``abstract_params``). With ``shard``, each leaf is drawn as the box
    ``shard(path, shape)`` of it (``path`` its keys; None: the whole
    leaf), with the whole draw's values (``layers.dense_init``): a rank
    draws its shard (``dist.tensor_parallel.init_shard_params``) without
    holding a whole leaf drawn piece by piece."""
    device = torch.device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    dtype = dtype_of(cfg.param_dtype)
    kinds = layer_kinds(cfg)
    shard = shard or (lambda path, shape: None)

    def ones(name):
        leaf = torch.ones((cfg.d_model,), dtype=dtype, device=device)
        index = shard((name,), leaf.shape)
        return leaf if index is None else leaf[index].clone()

    def matrix(name, shape, in_axis):
        return dense_init(gen, shape, in_axis, dtype, device,
                          shard((name,), shape))

    params: Dict[str, Any] = {
        "embed": matrix("embed", (cfg.vocab_size, cfg.d_model), 1),
        "final_norm": ones("final_norm"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = matrix("lm_head", (cfg.d_model, cfg.vocab_size),
                                   0)
    for seg, depth in kinds.items():
        kind = "dense" if seg == "enc" else seg
        params[seg] = _init_tree(gen, _block_shapes(cfg, kind), depth, dtype,
                                 device, shard, (seg,))
    if cfg.family == "hybrid":
        params["shared"] = _init_tree(gen, _block_shapes(cfg, "dense"), 0,
                                      dtype, device, shard, ("shared",))
    if cfg.family == "encdec":
        params["enc_norm"] = ones("enc_norm")
    return _zero_biases(params)


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The tree of ``init_params`` with its shapes and dtypes, on the
    ``meta`` device: no generator draw, no allocation."""
    return init_params(cfg, device="meta")


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter (or state) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ============================================================== attention

def _gqa_full(cfg: ModelConfig, p, x, *, causal=True, window=0, kv_x=None):
    """Full-sequence GQA (prefill); returns (out, (k, v) cache), k and v
    [B, Hkv, S_kv, hd] (v a transposed view). Self-attention (RoPE on q and
    k) unless ``kv_x`` gives the keys' and values' source: cross-attention,
    no RoPE. The head counts are those of ``p``'s (local) weights."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    hq, hkv = _heads(p, hd)
    x = copy_to_model(x)
    kv_src = x if kv_x is None else copy_to_model(kv_x)
    sk = kv_src.shape[1]
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (kv_src @ p["wk"]).reshape(b, sk, hkv, hd)
    v = (kv_src @ p["wv"]).reshape(b, sk, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if kv_x is None:
        cos, sin = rope_freqs(torch.arange(s, device=x.device), hd,
                              cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = prefill_attention(q, k, v, causal=causal, window=window)
    o = o.transpose(1, 2).reshape(b, s, hq * hd)
    return row_product(o, p["wo"]), (k, v)


def _heads(p, hd: int) -> Tuple[int, int]:
    """(query heads, KV heads) of an attention block's weights: the
    config's on one process, a rank's own under tensor parallelism."""
    return p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd


def _gqa_decode(cfg: ModelConfig, p, x, cache_kv, pos: int,
                kv_len: torch.Tensor, *, window: int = 0):
    """x [B, D], cache_kv (k, v) [B, Hkv·pad, S, hd]; writes the new key and
    value at ``pos`` IN PLACE (the cache is donated, as the JAX package's
    launcher donates it) and attends over the first ``kv_len`` positions.

    With a ``window`` the cache is a ring: the write lands on slot ``pos %
    S`` (keys carry their RoPE from the write, so the attention reads the
    slots in any order). Without one a write at ``pos >= S`` lands on slot
    S - 1, as the reference's ``dynamic_update_index_in_dim`` clamps it
    (PyTorch indexing would raise). A cache of another dtype than the
    compute dtype raises ``TypeError``, as the reference's update does.
    The head counts are those of ``p``'s (local) weights and the cache's
    replication factor is its heads over the KV heads."""
    b, _ = x.shape
    hd = cfg.head_dim
    hq, hkv = _heads(p, hd)
    k_cache, v_cache = cache_kv
    s_max = k_cache.shape[2]
    q = (x @ p["wq"]).reshape(b, hq, hd)
    k = (x @ p["wk"]).reshape(b, hkv, hd)
    v = (x @ p["wv"]).reshape(b, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(torch.full((1,), pos, device=x.device), hd,
                          cfg.rope_theta)                      # [1, hd/2]
    q = apply_rope(q[:, :, None], cos, sin)[:, :, 0]
    k = apply_rope(k[:, :, None], cos, sin)[:, :, 0]
    _check_cache_dtype(k, k_cache, cfg)
    pad = k_cache.shape[1] // hkv  # cache with replicated heads
    if pad > 1:
        k = k.repeat_interleave(pad, dim=1)
        v = v.repeat_interleave(pad, dim=1)
    slot = pos % s_max if window else min(pos, s_max - 1)
    k_cache[:, :, slot] = k
    v_cache[:, :, slot] = v
    o = decode_attention_host(q, k_cache, v_cache, kv_len)
    o = o.reshape(b, hq * hd)
    return row_product(o, p["wo"]), (k_cache, v_cache)


def _check_cache_dtype(new: torch.Tensor, cache: torch.Tensor,
                       cfg: ModelConfig) -> None:
    if new.dtype != cache.dtype:
        raise TypeError(
            f"decode_step: the new entries are {new.dtype} (compute dtype "
            f"{cfg.compute_dtype}) but the cache holds {cache.dtype}; pass "
            f"init_cache the compute dtype (the reference raises here too)")


def _mla_full(cfg: ModelConfig, p, x):
    """Full-sequence MLA (prefill); returns (out, (ckv [B, S, r] after its
    norm, k_rope [B, S, rope] after RoPE)). The attention (q and k of nope +
    rope, v of v_head_dim) runs through ``chunked_attention``, as in the
    reference. The heads are those of ``p``'s (local) ``wq_b``. Under
    tensor parallelism every rank computes the latents (q_lat, ckv and
    k_rope) whole, and they enter its heads through one f
    (``copy_all_to_model``): the backward sums the heads' parts of their
    gradients, so those of ``wq_a``, ``wkv_a``, their norms and ``x`` are
    whole on every rank (``TP_AHEAD``)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = _mla_heads(cfg, p)
    q_lat = rms_norm(x @ p["wq_a"], p["q_ln"], cfg.norm_eps)
    ckv, k_rope = (x @ p["wkv_a"]).split([m.kv_lora_rank, m.qk_rope_dim],
                                         dim=-1)
    ckv = rms_norm(ckv, p["kv_ln"], cfg.norm_eps)
    q_lat, ckv, k_rope = copy_all_to_model(q_lat, ckv, k_rope)
    q = (q_lat @ p["wq_b"]).reshape(b, s, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    kvb = (ckv @ p["wkv_b"]).reshape(b, s, h, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kvb.split([m.qk_nope_dim, m.v_head_dim], dim=-1)
    cos, sin = rope_freqs(torch.arange(s, device=x.device), m.qk_rope_dim,
                          cfg.rope_theta)
    q_rope = apply_rope(q_rope.transpose(1, 2), cos, sin)
    k_rope = apply_rope(k_rope[:, None], cos, sin)            # [B, 1, S, rope]
    q_full = torch.cat([q_nope.transpose(1, 2), q_rope], -1)
    k_full = torch.cat([k_nope.transpose(1, 2),
                        k_rope.expand(b, h, s, m.qk_rope_dim)], -1)
    o = chunked_attention(q_full, k_full, v.transpose(1, 2), causal=True)
    o = o.transpose(1, 2).reshape(b, s, h * m.v_head_dim)
    return row_product(o, p["wo"]), (ckv, k_rope[:, 0])


def _mla_heads(cfg: ModelConfig, p) -> int:
    """MLA's heads in ``p``'s ``wq_b``: the config's on one process, a
    rank's own under tensor parallelism."""
    m = cfg.mla
    return p["wq_b"].shape[-1] // (m.qk_nope_dim + m.qk_rope_dim)


def _mla_decode(cfg: ModelConfig, p, x, cache, pos: int):
    """Absorbed MLA decode: attention runs in the latent space over cache
    (ckv [B, S, r], k_rope [B, S, rope]), written IN PLACE at ``pos`` (slot
    S - 1 for ``pos >= S``, as the reference's update clamps it), over the
    positions ``<= pos``; the einsums in f32. The heads are those of
    ``p``'s (local) ``wq_b``."""
    m = cfg.mla
    b, _ = x.shape
    h = _mla_heads(cfg, p)
    ckv_cache, krope_cache = cache
    s_max = ckv_cache.shape[1]
    q_lat = rms_norm(x @ p["wq_a"], p["q_ln"], cfg.norm_eps)
    q = (q_lat @ p["wq_b"]).reshape(b, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    ckv_t, krope_t = (x @ p["wkv_a"]).split([m.kv_lora_rank, m.qk_rope_dim],
                                            dim=-1)
    ckv_t = rms_norm(ckv_t, p["kv_ln"], cfg.norm_eps)
    cos, sin = rope_freqs(torch.full((1,), pos, device=x.device),
                          m.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope[:, :, None], cos, sin)[:, :, 0]
    krope_t = apply_rope(krope_t[:, None, None], cos, sin)[:, 0, 0]
    _check_cache_dtype(ckv_t, ckv_cache, cfg)
    slot = min(pos, s_max - 1)
    ckv_cache[:, slot] = ckv_t
    krope_cache[:, slot] = krope_t

    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim)
    w_k, w_v = wkv_b.float().split([m.qk_nope_dim, m.v_head_dim], dim=-1)
    ckv_f = ckv_cache.float()
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope.float(), w_k)   # [B, H, r]
    scores = (torch.einsum("bhr,bsr->bhs", q_abs, ckv_f)
              + torch.einsum("bhp,bsp->bhs", q_rope.float(),
                             krope_cache.float()))
    scores = scores * (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    mask = torch.arange(s_max, device=x.device) <= pos
    w = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", w, ckv_f)
    o = torch.einsum("bhr,rhv->bhv", ctx, w_v)
    o = o.reshape(b, h * m.v_head_dim).to(x.dtype)
    return row_product(o, p["wo"]), (ckv_cache, krope_cache)


# ================================================================= blocks

def _cast_params(cfg: ModelConfig, p):
    """Cast float params to the compute dtype at the point of use (norm
    weights are re-upcast inside rms_norm)."""
    ct = dtype_of(cfg.compute_dtype)
    if isinstance(p, dict):
        return {k: _cast_params(cfg, v) for k, v in p.items()}
    return p.to(ct) if p.is_floating_point() else p


def _ffn_apply(cfg: ModelConfig, p, x):
    x = copy_to_model(x)
    if cfg.ffn == "swiglu":
        return swiglu(x, p["w_gate"], p["w_in"], p["w_out"], row_product)
    return gelu_mlp(x, p["w_in"], p["w_out"], row_product)


def _mlp(cfg: ModelConfig, p, h):
    """A block's FFN on h [B, S, D]: the experts of a moe block (``"moe"``
    in its parameters), the dense FFN otherwise."""
    if "moe" in p:
        return moe_ffn(copy_to_model(h), p["moe"], cfg.moe, cfg.ffn,
                       dtype_of(cfg.compute_dtype))
    return _ffn_apply(cfg, p["ffn"], h)


def _block_full(cfg: ModelConfig, kind: str, p, x, *, enc_out=None,
                window: int = 0):
    """Full-sequence block of kind ssm, dense (causal), moe (causal, the
    experts for its FFN), enc (the encoder's, not causal) or cross (the
    decoder's: causal self-attention, then attention over ``enc_out``);
    returns (x, the layer's cache: None for ssm, the (k, v) of its
    self-attention, or (ckv, k_rope) with MLA, and for cross ((k, v),
    (k, v) of the cross-attention))."""
    p = _cast_params(cfg, p)
    if kind == "ssm":
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        return x + mamba2_forward(h, p["mamba"], cfg.ssm), None
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attention == "mla" and kind in ("dense", "moe"):
        att, cache = _mla_full(cfg, p["attn"], h)
    else:
        att, cache = _gqa_full(cfg, p["attn"], h, causal=kind != "enc",
                               window=window)
    x = x + att
    if kind == "cross":
        hc = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        catt, ccache = _gqa_full(cfg, p["cross"], hc, causal=False,
                                 kv_x=enc_out)
        x = x + catt
        cache = (cache, ccache)
    return x + _mlp(cfg, p, rms_norm(x, p["ln2"], cfg.norm_eps)), cache


def _head(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the LM head: the logits on one process; under
    tensor parallelism the rank's part of them (``head_logits``: its
    vocabulary's logits, or its f32 partial of all of them), which
    ``gather_logits`` makes whole."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head_logits(cfg, x, head)


# ============================================================ full forward

def forward(cfg: ModelConfig, params, tokens=None, embeds=None,
            enc_tokens=None, enc_embeds=None, *, collect_cache: bool = False):
    """Training/prefill forward -> (logits [B, S, V], caches or None).
    With ``collect_cache`` the caches are the reference's: per segment the
    stacked layer caches, ``caches["dense"]`` (and the moe family's
    ``caches["moe"]``) = (k, v), each [L, B, Hkv, S, hd], or with MLA
    (ckv [L, B, S, r], k_rope [L, B, S, rope]); ``caches["ssm"]`` = None
    (the ssm blocks collect none); ``caches["cross"]`` = ((k, v) of the
    decoder's self-attention, (k, v) over the encoder's output, [L, B,
    Hkv, S_enc, hd]); for the hybrid ``{"ssm": [], "shared_kv": [(k, v)
    of each shared site]}``. The encdec family's encoder reads
    ``enc_tokens`` or ``enc_embeds``."""
    logits, caches = _forward(cfg, params, tokens, embeds, enc_tokens,
                              enc_embeds, collect_cache)
    return gather_logits(cfg, logits), caches


def _forward(cfg, params, tokens, embeds, enc_tokens, enc_embeds,
             collect_cache):
    """``forward`` with the head's own logits (a rank's part under tensor
    parallelism, ``head_logits``)."""
    require(cfg)
    kinds = layer_kinds(cfg)
    x = (embed_lookup(cfg, params["embed"], tokens) if embeds is None
         else embeds)
    x = annotate(x.to(dtype_of(cfg.compute_dtype)), act_spec())
    caches: Dict[str, Any] = {}
    enc_out = None
    if cfg.family == "encdec":
        e = (embed_lookup(cfg, params["embed"], enc_tokens)
             if enc_embeds is None else enc_embeds)
        e, _ = _scan_segment(cfg, "dense", params["enc"], e.to(x.dtype),
                             causal_kind="enc")
        enc_out = rms_norm(e, params["enc_norm"], cfg.norm_eps)
    if cfg.family == "hybrid":
        x, caches = _hybrid_forward(cfg, params, x, collect_cache)
    else:
        for seg in kinds:
            if seg == "enc":
                continue
            x, cache = _scan_segment(cfg, seg, params[seg], x,
                                     enc_out=enc_out,
                                     collect_cache=collect_cache)
            if collect_cache:
                caches[seg] = cache
    logits = annotate(_head(cfg, params, x), P(("pod", "data"), None,
                                               "model"))
    return logits, (caches if collect_cache else None)


def _stack(caches: List[Any]) -> Any:
    """Per-layer caches (tensors, tuples of them, or None) stacked layer
    first, as ``lax.scan`` stacks the reference's."""
    if not caches or caches[0] is None:
        return None
    if isinstance(caches[0], tuple):
        return tuple(_stack(list(c)) for c in zip(*caches))
    return torch.stack(caches)


def _scan_segment(cfg, kind, seg_params, x, *, enc_out=None,
                  collect_cache=False, causal_kind=None, layers=None):
    """The blocks of a stacked segment in order (all of them, or the
    indices ``layers``), a Python loop in place of the reference's
    ``lax.scan``; ``causal_kind`` overrides the block kind (the encoder's
    "enc"). ``seg_params`` is the stacked tree, or its layers already
    unstacked (``unstack``). Under grad each block is checkpointed by
    ``cfg.remat`` and ``REPRO_REMAT`` (``_remat``). Returns (x, the stacked
    caches or None)."""
    kind = causal_kind or kind
    per_layer = (seg_params if isinstance(seg_params, list)
                 else unstack(seg_params))
    block = _remat(cfg, _block_full, per_layer[0] if per_layer else {}, x)
    layer_caches = []
    for i in (range(len(per_layer)) if layers is None else layers):
        # the reference's sequence-parallel layout between layers
        x, cache = block(cfg, kind, per_layer[i], annotate(x, act_spec()),
                         enc_out=enc_out)
        x = annotate(x, act_spec())
        if collect_cache:
            layer_caches.append(cache)
    return x, (_stack(layer_caches) if collect_cache else None)


def unstack(tree) -> List[Any]:
    """The per-layer trees of a stacked tree, each leaf unbound once: under
    grad the backward of ``unbind`` is one ``stack`` per leaf, where
    indexing layer by layer would allocate a zero gradient the size of the
    whole stack for every layer."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        depth = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(depth)]
    return list(tree.unbind(0))


def _saves_matmuls(ctx, op, *args, **kwargs):
    """``dots``: keep the outputs of the batch-free products (``aten.mm``:
    the projections) and recompute the rest, as JAX's
    ``dots_with_no_batch_dims_saveable``; attention's einsums are
    ``aten.bmm``, products with batch dims."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, block, layer_p, x):
    """``block`` as a layer loop runs it: under grad (an operand that needs
    it) and ``cfg.remat``, checkpointed by ``remat_policy()``, with the
    weights' casts inside the checkpoint so that no compute-dtype copy of
    them is kept for the backward; otherwise ``block`` itself."""
    policy = remat_policy()
    if (not cfg.remat or policy == "none"
            or not needs_grad(x, *_leaves(layer_p))):
        return block
    if policy == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _saves_matmuls)
        return functools.partial(checkpoint, block, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=context)
    if policy != "full":
        raise ValueError(f"REPRO_REMAT={policy!r}: none, full or dots")
    return functools.partial(checkpoint, block, use_reentrant=False,
                             preserve_rng_state=False)


def _leaves(tree):
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _depth(tree) -> int:
    """Layers of a stacked parameter tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _hybrid_forward(cfg, params, x, collect_cache):
    """The Mamba-2 backbone with the shared attention block (sliding
    window) between its segments."""
    segs = _hybrid_segments(cfg)
    caches: Dict[str, Any] = {"ssm": [], "shared_kv": []}
    ssm_layers = unstack(params["ssm"])
    shared = _remat(cfg, _block_full, params["shared"], x)
    offset = 0
    for si, depth in enumerate(segs):
        x, _ = _scan_segment(cfg, "ssm", ssm_layers, x,
                             layers=range(offset, offset + depth))
        offset += depth
        if si < len(segs) - 1:
            x, kv = shared(cfg, "dense", params["shared"], x,
                           window=cfg.sliding_window)
            if collect_cache:
                caches["shared_kv"].append(kv)
    return x, caches


def _hybrid_segments(cfg) -> Tuple[int, ...]:
    """Depths of the hybrid's Mamba-2 segments: ``shared_attn_every``
    layers each, the last one shorter if the layers do not divide."""
    every, n = cfg.shared_attn_every, cfg.n_layers
    return tuple(min(every, n - done) for done in range(0, n, every))


def prefill(cfg: ModelConfig, params, tokens=None, embeds=None,
            enc_tokens=None, enc_embeds=None):
    """Forward over the prompt; returns last-position logits (cache wiring
    for incremental decode is exercised via decode_step). Under tensor
    parallelism only the last position's logits are made whole (gathered,
    or its f32 partials summed)."""
    logits, _ = _forward(cfg, params, tokens, embeds, enc_tokens, enc_embeds,
                         False)
    return gather_logits(cfg, logits[:, -1])


def lm_loss(cfg: ModelConfig, params, batch, count=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``forward`` over ``batch`` (tokens
    or embeds, enc_tokens or enc_embeds, labels): log-softmax in f32,
    labels < 0 masked out, the masked sum over ``count`` (``batch``'s kept
    labels unless given: a data rank passes its global batch's, so that
    the ranks' losses sum to the global one)."""
    logits, _ = forward(cfg, params, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"),
                        enc_tokens=batch.get("enc_tokens"),
                        enc_embeds=batch.get("enc_embeds"))
    return next_token_loss(logits, batch["labels"], count)


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor,
                    count: torch.Tensor | None = None) -> torch.Tensor:
    """The masked mean negative log-likelihood of ``labels`` under
    ``logits`` (log-softmax in f32, labels < 0 masked out): the masked sum
    over ``count``, the labels kept (this batch's unless given; a data
    rank passes the global batch's)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    count = mask.sum() if count is None else count
    return -(ll * mask).sum() / torch.clamp(count, min=1.0)


# ================================================================ serving

class DecodeCache(NamedTuple):
    pos: int                    # tokens decoded so far
    layers: Any                 # per-family cache tree


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, enc_out=None, *, device="cuda",
               kv_head_pad: int = 1) -> DecodeCache:
    """The decode cache at position 0. A KV cache is the stacked (k, v),
    each [L, B, Hkv · kv_head_pad, S, hd] of zeros (``kv_head_pad``
    replicates each KV head in the layout; the decode step detects the
    factor from the shape). Per family: dense and vlm one over all layers
    (S = ``max_seq``); moe one per segment ("dense", if the config has
    leading dense layers, and "moe"), with MLA the latent cache (ckv [L, B,
    S, r], k_rope [L, B, S, rope]) in its place; ssm the stacked Mamba-2
    state, which does not grow with ``max_seq``; hybrid that state and a
    ring of min(max_seq, sliding_window) slots per shared attention site;
    encdec one over the decoder's layers for their self-attention
    (``cross_self``) and ``enc_out``, the (k, v) pair [L, B, Hkv, S_enc,
    hd] the cross-attention reads (the forward's collected cross caches,
    or the serve launcher's zeros)."""
    hkv = max(cfg.n_kv_heads, 1) * max(kv_head_pad, 1)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(n, s):
        shape = (n, batch, hkv, s, cfg.head_dim)
        return zeros(*shape), zeros(*shape)

    if cfg.family in ("dense", "vlm"):
        layers = {"dense": kv(cfg.n_layers, max_seq)}
    elif cfg.family == "moe":
        m = cfg.mla
        layers = {seg: ((zeros(n, batch, max_seq, m.kv_lora_rank),
                         zeros(n, batch, max_seq, m.qk_rope_dim))
                        if cfg.attention == "mla" else kv(n, max_seq))
                  for seg, n in layer_kinds(cfg).items()}
    elif cfg.family == "ssm":
        layers = {"ssm": _stacked_ssm_state(cfg, cfg.n_layers, batch, dtype,
                                            device)}
    elif cfg.family == "hybrid":
        window = cfg.sliding_window or 0
        sites = len(_hybrid_segments(cfg)) - 1
        layers = {"ssm": _stacked_ssm_state(cfg, cfg.n_layers, batch, dtype,
                                            device),
                  "shared_kv": kv(max(sites, 1), min(max_seq, window)
                                  if window else max_seq)}
    else:
        layers = {"cross_self": kv(cfg.n_layers, max_seq), "enc_out": enc_out}
    return DecodeCache(pos=0, layers=layers)


def _stacked_ssm_state(cfg, n, batch, dtype, device) -> Mamba2State:
    st = mamba2_init_state(cfg.ssm, cfg.d_model, batch, dtype, device)
    return Mamba2State(*(a.expand(n, *a.shape).clone() for a in st))


def decode_step(cfg: ModelConfig, params, token_or_embed: torch.Tensor,
                cache: DecodeCache):
    """One decode step: token [B] (or embed [B, D]) -> (logits [B, V],
    cache). Mamba-2 states are returned anew and the input's left as they
    are. KV and latent caches are donated: the step writes the new entries
    into their tensors in place and returns them, so a cache must not be
    used again after a step."""
    require(cfg)
    if token_or_embed.dim() == 1:
        x = embed_lookup(cfg, params["embed"], token_or_embed)
    else:
        x = token_or_embed
    x = x.to(dtype_of(cfg.compute_dtype))
    pos, layers = cache.pos, dict(cache.layers)
    if cfg.family in ("dense", "vlm"):
        x, layers["dense"] = _decode_scan_gqa(cfg, params["dense"], x,
                                              layers["dense"], pos)
    elif cfg.family == "moe":
        scan = _decode_scan_mla if cfg.attention == "mla" else \
            _decode_scan_gqa
        for seg in layer_kinds(cfg):
            x, layers[seg] = scan(cfg, params[seg], x, layers[seg], pos)
    elif cfg.family == "ssm":
        x, layers["ssm"] = _decode_scan_ssm(cfg, params["ssm"], x,
                                            layers["ssm"], pos)
    elif cfg.family == "hybrid":
        x, layers = _decode_hybrid(cfg, params, x, layers, pos)
    else:
        x, layers["cross_self"] = _decode_scan_gqa(
            cfg, params["cross"], x, layers["cross_self"], pos,
            enc_out=layers["enc_out"])
    logits = annotate(gather_logits(cfg, _head(cfg, params, x)),
                      P(("pod", "data"), "model"))
    return logits, DecodeCache(pos=pos + 1, layers=layers)


def _kv_len(x: torch.Tensor, pos: int, s_max: int) -> torch.Tensor:
    """kv_len = min(pos + 1, S) for the batch, built once a step on the
    device for every layer."""
    return torch.full((x.shape[0],), min(pos + 1, s_max), dtype=torch.int32,
                      device=x.device)


def _decode_block_gqa(cfg, p, x, kv, pos, kv_len, *, window=0,
                      enc_out_kv=None):
    """A decode block: self-attention over ``kv`` (written in place), then
    with ``enc_out_kv`` attention over the encoder's (k, v) (every
    position, no RoPE), then the FFN."""
    p = _cast_params(cfg, p)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    att, kv = _gqa_decode(cfg, p["attn"], h, kv, pos, kv_len, window=window)
    x = x + att
    if enc_out_kv is not None:
        hc = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        hq, _ = _heads(p["cross"], cfg.head_dim)
        q = (hc @ p["cross"]["wq"]).reshape(x.shape[0], hq, cfg.head_dim)
        o = decode_attention_host(q, enc_out_kv[0], enc_out_kv[1])
        x = x + row_product(o.reshape(x.shape[0], -1), p["cross"]["wo"])
    return x + _decode_mlp(cfg, p, rms_norm(x, p["ln2"], cfg.norm_eps)), kv


def _decode_mlp(cfg: ModelConfig, p, h):
    """A block's FFN on one token a row, h [B, D]: a moe block routes the
    batch as B tokens of one position (capacity from T = B)."""
    return _mlp(cfg, p, h[:, None])[:, 0] if "moe" in p else \
        _ffn_apply(cfg, p["ffn"], h)


def _decode_scan_gqa(cfg, seg_params, x, kv_cache, pos: int, *,
                     enc_out=None):
    """Every layer's decode block over the stacked (k, v) cache, written in
    place; with ``enc_out`` (the encdec decoder) layer i also attends over
    the encoder's (k, v) ``enc_out[0][i], enc_out[1][i]``."""
    k_all, v_all = kv_cache
    kv_len = _kv_len(x, pos, k_all.shape[3])
    for i in range(k_all.shape[0]):
        x, _ = _decode_block_gqa(
            cfg, _layer(seg_params, i), x, (k_all[i], v_all[i]), pos, kv_len,
            enc_out_kv=None if enc_out is None else (enc_out[0][i],
                                                     enc_out[1][i]))
    return x, (k_all, v_all)


def _decode_scan_mla(cfg, seg_params, x, cache, pos: int):
    """Every layer's MLA decode block over the stacked latent cache (ckv,
    k_rope), written in place; dense FFN or experts by the layer."""
    ckv_all, krope_all = cache
    for i in range(ckv_all.shape[0]):
        p = _cast_params(cfg, _layer(seg_params, i))
        att, _ = _mla_decode(cfg, p["attn"],
                             rms_norm(x, p["ln1"], cfg.norm_eps),
                             (ckv_all[i], krope_all[i]), pos)
        x = x + att
        x = x + _decode_mlp(cfg, p, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, (ckv_all, krope_all)


def _ssm_steps(cfg, seg_params, x, states: Mamba2State, layers):
    """The Mamba-2 decode steps of ``layers``; returns (x, their new conv
    states, their new SSM states)."""
    convs, ssms = [], []
    for i in layers:
        layer_p = _cast_params(cfg, _layer(seg_params, i))
        h = rms_norm(x, layer_p["ln"], cfg.norm_eps)
        y, st = mamba2_step(h, Mamba2State(states.conv[i], states.ssm[i]),
                            layer_p["mamba"], cfg.ssm)
        x = x + y
        convs.append(st.conv)
        ssms.append(st.ssm)
    return x, convs, ssms


def _decode_scan_ssm(cfg, seg_params, x, states: Mamba2State, pos):
    x, convs, ssms = _ssm_steps(cfg, seg_params, x, states,
                                range(cfg.n_layers))
    return x, Mamba2State(torch.stack(convs), torch.stack(ssms))


def _decode_hybrid(cfg, params, x, layers, pos: int):
    """The backbone's decode steps with the shared block between its
    segments, site ``si`` over its own ring ``shared_kv[·][si]`` (written
    in place at slot ``pos % S``)."""
    segs = _hybrid_segments(cfg)
    states = layers["ssm"]
    k_all, v_all = layers["shared_kv"]
    kv_len = _kv_len(x, pos, k_all.shape[3])
    convs, ssms = [], []
    offset = 0
    for si, depth in enumerate(segs):
        x, c, s = _ssm_steps(cfg, params["ssm"], x, states,
                             range(offset, offset + depth))
        convs += c
        ssms += s
        offset += depth
        if si < len(segs) - 1:
            x, _ = _decode_block_gqa(cfg, params["shared"], x,
                                     (k_all[si], v_all[si]), pos, kv_len,
                                     window=cfg.sliding_window)
    return x, {"ssm": Mamba2State(torch.stack(convs), torch.stack(ssms)),
               "shared_kv": (k_all, v_all)}
