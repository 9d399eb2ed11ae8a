"""The model zoo's init / forward / prefill / decode, for the dense family
(llama-style GQA) and the ssm family (Mamba-2) so far.

The port of ``repro.models.transformer`` for ``family`` in ``("dense",
"ssm")``. The other families (vlm, moe, hybrid, encdec) raise
``NotImplementedError``: their blocks (MoE, MLA, the hybrid's shared
attention, cross-attention) are ROADMAP item A10 and their serving path
item A12. Parameters are a dict of tensors with the JAX package's tree and
stacked ``[n_layers, ...]`` leaves; layers run as a Python loop over that
stack. There is one device, so the JAX package's sharding annotations have
no counterpart.

Attention goes through ``prefill_attention`` and ``decode_attention_host``
(``models/attention.py``): the hand-written kernels on CUDA tensors, the
plain versions on CPU tensors.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..configs.base import ModelConfig
from .attention import decode_attention_host, prefill_attention
from .layers import (apply_rope, dense_init, gelu_mlp, rms_norm, rope_freqs,
                     stacked_dense_init, swiglu)
from .mamba2 import (Mamba2State, mamba2_forward, mamba2_init_state,
                     mamba2_params_shapes, mamba2_step)

FAMILIES = ("dense", "ssm")


def _require_family(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{what}: the port runs the dense and ssm families so far, not "
            f"{cfg.family!r} ({cfg.name}); the {cfg.family} family's model is "
            f"ROADMAP item A10 and its serving path item A12")


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("float32", "bfloat16")."""
    return getattr(torch, name)


# =============================================================== parameters

def _attn_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    if cfg.attention == "mla":
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is ROADMAP item A10")
    d, hd = cfg.d_model, cfg.head_dim
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
    return {"ln1": (d,), "ln2": (d,), "attn": _attn_shapes(cfg),
            "ffn": _ffn_shapes(cfg)}


def _init_tree(gen: torch.Generator, shapes, n_stack: int, dtype,
               device) -> Any:
    """Norm weights and biases (1-D) are ones (biases are re-zeroed by
    :func:`_zero_biases`); matrices are LeCun-normal in their first axis,
    one draw per layer when stacked."""
    if isinstance(shapes, dict):
        return {k: _init_tree(gen, v, n_stack, dtype, device)
                for k, v in shapes.items()}
    if len(shapes) == 1:
        return torch.ones((n_stack, *shapes) if n_stack else shapes,
                          dtype=dtype, device=device)
    if n_stack:
        return stacked_dense_init(gen, n_stack, shapes, 0, dtype, device)
    return dense_init(gen, shapes, 0, dtype, device)


def _zero_biases(tree, names=("router_bias", "conv_b", "dt_bias")):
    """Zero the biases, and ``a_log`` (A = -1, a stable decay)."""
    return {k: (_zero_biases(v, names) if isinstance(v, dict)
                else torch.zeros_like(v) if k in names or k == "a_log"
                else v)
            for k, v in tree.items()}


def layer_kinds(cfg: ModelConfig) -> Dict[str, int]:
    """Named layer segments -> stack depth (one per family so far)."""
    _require_family(cfg, "layer_kinds")
    return {cfg.family: cfg.n_layers}


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters with the JAX package's tree, shapes and init rules,
    drawn from a generator on ``device`` seeded with ``seed``. The numbers
    differ from ``repro``'s ``init_params``; to compute the same function as
    ``repro``, convert its parameters with :mod:`repro_torch.models.convert`."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)
    kinds = layer_kinds(cfg)
    params: Dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), 1, dtype,
                            device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), 0,
                                       dtype, device)
    for seg, depth in kinds.items():
        params[seg] = _init_tree(gen, _block_shapes(cfg, seg), depth, dtype,
                                 device)
    return _zero_biases(params)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter (or state) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ============================================================== attention

def _gqa_full(cfg: ModelConfig, p, x):
    """Full-sequence causal GQA (prefill); returns (out, (k, v) cache), k
    and v [B, Hkv, S, hd] (v a transposed view)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(torch.arange(s, device=x.device), hd,
                          cfg.rope_theta)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    v = v.transpose(1, 2)
    o = prefill_attention(q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
    return o @ p["wo"], (k, v)


def _gqa_decode(cfg: ModelConfig, p, x, cache_kv, pos: int,
                kv_len: torch.Tensor):
    """x [B, D], cache_kv (k, v) [B, Hkv·pad, S, hd]; writes the new key and
    value at ``pos`` IN PLACE (the cache is donated, as the JAX package's
    launcher donates it) and attends over the first ``kv_len`` positions.

    A write at ``pos >= S`` lands on slot S - 1, as the reference's
    ``dynamic_update_index_in_dim`` clamps it (PyTorch indexing would
    raise). A cache of another dtype than the compute dtype raises
    ``TypeError``, as the reference's update does."""
    b, _ = x.shape
    hd = cfg.head_dim
    k_cache, v_cache = cache_kv
    s_max = k_cache.shape[2]
    q = (x @ p["wq"]).reshape(b, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(torch.full((1,), pos, device=x.device), hd,
                          cfg.rope_theta)                      # [1, hd/2]
    q = apply_rope(q[:, :, None], cos, sin)[:, :, 0]
    k = apply_rope(k[:, :, None], cos, sin)[:, :, 0]
    if k.dtype != k_cache.dtype:
        raise TypeError(
            f"decode_step: the new keys are {k.dtype} (compute dtype "
            f"{cfg.compute_dtype}) but the cache holds {k_cache.dtype}; pass "
            f"init_cache the compute dtype (the reference raises here too)")
    pad = k_cache.shape[1] // cfg.n_kv_heads  # cache with replicated heads
    if pad > 1:
        k = k.repeat_interleave(pad, dim=1)
        v = v.repeat_interleave(pad, dim=1)
    slot = min(pos, s_max - 1)
    k_cache[:, :, slot] = k
    v_cache[:, :, slot] = v
    o = decode_attention_host(q, k_cache, v_cache, kv_len)
    o = o.reshape(b, cfg.n_heads * hd)
    return o @ p["wo"], (k_cache, v_cache)


# ================================================================= blocks

def _cast_params(cfg: ModelConfig, p):
    """Cast float params to the compute dtype at the point of use (norm
    weights are re-upcast inside rms_norm)."""
    ct = dtype_of(cfg.compute_dtype)
    if isinstance(p, dict):
        return {k: _cast_params(cfg, v) for k, v in p.items()}
    return p.to(ct) if p.is_floating_point() else p


def _ffn_apply(cfg: ModelConfig, p, x):
    if cfg.ffn == "swiglu":
        return swiglu(x, p["w_gate"], p["w_in"], p["w_out"])
    return gelu_mlp(x, p["w_in"], p["w_out"])


def _block_full(cfg: ModelConfig, kind: str, p, x):
    """Full-sequence block of the ssm or dense kind; returns (x, the
    layer's cache: None for ssm, the (k, v) of its attention for dense)."""
    p = _cast_params(cfg, p)
    if kind == "ssm":
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        return x + mamba2_forward(h, p["mamba"], cfg.ssm, cfg.d_model), None
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    att, cache = _gqa_full(cfg, p["attn"], h)
    x = x + att
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn_apply(cfg, p["ffn"], h2), cache


def _head(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


# ============================================================ full forward

def forward(cfg: ModelConfig, params, tokens=None, embeds=None, *,
            collect_cache: bool = False):
    """Training/prefill forward -> (logits [B, S, V], caches or None).
    With ``collect_cache`` the caches are, per segment, the reference's
    stacked layer caches: ``caches["dense"]`` = (k, v), each [L, B, Hkv, S,
    hd]; ``caches["ssm"]`` = None (the ssm blocks collect none)."""
    kinds = layer_kinds(cfg)
    x = params["embed"][tokens] if embeds is None else embeds
    x = x.to(dtype_of(cfg.compute_dtype))
    caches: Dict[str, Any] = {}
    for seg, depth in kinds.items():
        layer_caches = []
        for i in range(depth):
            x, cache = _block_full(cfg, seg, _layer(params[seg], i), x)
            if collect_cache and cache is not None:
                layer_caches.append(cache)
        if collect_cache:
            caches[seg] = (tuple(torch.stack(c) for c in zip(*layer_caches))
                           if layer_caches else None)
    return _head(cfg, params, x), (caches if collect_cache else None)


def prefill(cfg: ModelConfig, params, tokens=None, embeds=None):
    """Forward over the prompt; returns last-position logits (cache wiring
    for incremental decode is exercised via decode_step)."""
    logits, _ = forward(cfg, params, tokens=tokens, embeds=embeds)
    return logits[:, -1]


# ================================================================ serving

class DecodeCache(NamedTuple):
    pos: int                    # tokens decoded so far
    layers: Any                 # per-family cache tree


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device="cuda",
               kv_head_pad: int = 1) -> DecodeCache:
    """The decode cache at position 0. For the dense family it is the
    stacked (k, v), each [L, B, Hkv · kv_head_pad, max_seq, hd] of zeros
    (``kv_head_pad`` replicates each KV head in the layout; the decode step
    detects the factor from the shape); for the ssm family the stacked
    Mamba-2 state, which does not grow with ``max_seq``."""
    _require_family(cfg, "init_cache")
    if cfg.family == "ssm":
        return DecodeCache(pos=0, layers={"ssm": _stacked_ssm_state(
            cfg, cfg.n_layers, batch, dtype, device)})
    hkv = max(cfg.n_kv_heads, 1) * max(kv_head_pad, 1)
    shape = (cfg.n_layers, batch, hkv, max_seq, cfg.head_dim)
    return DecodeCache(pos=0, layers={"dense": (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device))})


def _stacked_ssm_state(cfg, n, batch, dtype, device) -> Mamba2State:
    st = mamba2_init_state(cfg.ssm, cfg.d_model, batch, dtype, device)
    return Mamba2State(*(a.expand(n, *a.shape).clone() for a in st))


def decode_step(cfg: ModelConfig, params, token_or_embed: torch.Tensor,
                cache: DecodeCache):
    """One decode step: token [B] (or embed [B, D]) -> (logits [B, V],
    cache). The ssm family leaves the input cache as it is. The dense
    family's cache is donated: the step writes the new keys and values into
    its tensors in place and returns them, so a cache must not be used again
    after a step."""
    _require_family(cfg, "decode_step")
    if token_or_embed.dim() == 1:
        x = params["embed"][token_or_embed]
    else:
        x = token_or_embed
    x = x.to(dtype_of(cfg.compute_dtype))
    scan = _decode_scan_ssm if cfg.family == "ssm" else _decode_scan_gqa
    x, new = scan(cfg, params[cfg.family], x, cache.layers[cfg.family],
                  cache.pos)
    layers = dict(cache.layers, **{cfg.family: new})
    return _head(cfg, params, x), DecodeCache(pos=cache.pos + 1,
                                              layers=layers)


def _decode_block_gqa(cfg, p, x, kv, pos, kv_len):
    p = _cast_params(cfg, p)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    att, kv = _gqa_decode(cfg, p["attn"], h, kv, pos, kv_len)
    x = x + att
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn_apply(cfg, p["ffn"], h2), kv


def _decode_scan_gqa(cfg, seg_params, x, kv_cache, pos: int):
    """Every layer's decode block over the stacked (k, v) cache, written in
    place. kv_len = min(pos + 1, S) is built once, on the device, for all
    layers."""
    k_all, v_all = kv_cache
    kv_len = torch.full((x.shape[0],), min(pos + 1, k_all.shape[3]),
                        dtype=torch.int32, device=x.device)
    for i in range(k_all.shape[0]):
        x, _ = _decode_block_gqa(cfg, _layer(seg_params, i), x,
                                 (k_all[i], v_all[i]), pos, kv_len)
    return x, (k_all, v_all)


def _decode_scan_ssm(cfg, seg_params, x, states: Mamba2State, pos):
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        layer_p = _cast_params(cfg, _layer(seg_params, i))
        h = rms_norm(x, layer_p["ln"], cfg.norm_eps)
        y, st = mamba2_step(h, Mamba2State(states.conv[i], states.ssm[i]),
                            layer_p["mamba"], cfg.ssm, cfg.d_model)
        x = x + y
        convs.append(st.conv)
        ssms.append(st.ssm)
    return x, Mamba2State(torch.stack(convs), torch.stack(ssms))
