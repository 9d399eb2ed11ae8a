"""The model zoo's init / forward / prefill / decode, for the ssm family
(Mamba-2) so far.

The port of ``repro.models.transformer`` for ``family == "ssm"``. The
other families (dense, vlm, moe, hybrid, encdec) raise
``NotImplementedError``: their attention, MoE and hybrid blocks are ROADMAP
item A10 and their serving path item A12. Parameters are a dict of tensors
with the JAX package's tree and stacked ``[n_layers, ...]`` leaves; layers
run as a Python loop over that stack. There is one device, so the JAX
package's sharding annotations have no counterpart.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..configs.base import ModelConfig
from .layers import dense_init, rms_norm, stacked_dense_init
from .mamba2 import (Mamba2State, mamba2_forward, mamba2_init_state,
                     mamba2_params_shapes, mamba2_step)


def _require_ssm(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{what}: the port runs the ssm family so far, not "
            f"{cfg.family!r} ({cfg.name}); the other families' models are "
            f"ROADMAP item A10 and their serving path item A12")


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("float32", "bfloat16")."""
    return getattr(torch, name)


# =============================================================== parameters

def _block_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    _require_ssm(cfg, "_block_shapes")
    return {"ln": (cfg.d_model,),
            "mamba": mamba2_params_shapes(cfg.ssm, cfg.d_model)}


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


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters with the JAX package's tree, shapes and init rules,
    drawn from a generator on ``device`` seeded with ``seed``. The numbers
    differ from ``repro``'s ``init_params``; to compute the same function as
    ``repro``, convert its parameters with :mod:`repro_torch.models.convert`."""
    _require_ssm(cfg, "init_params")
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), 1, dtype,
                            device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), 0,
                                       dtype, device)
    params["ssm"] = _init_tree(gen, _block_shapes(cfg), cfg.n_layers,
                               dtype, device)
    return _zero_biases(params)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter (or state) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ================================================================= blocks

def _cast_params(cfg: ModelConfig, p):
    """Cast float params to the compute dtype at the point of use (norm
    weights are re-upcast inside rms_norm)."""
    ct = dtype_of(cfg.compute_dtype)
    if isinstance(p, dict):
        return {k: _cast_params(cfg, v) for k, v in p.items()}
    return p.to(ct) if p.is_floating_point() else p


def _block_full(cfg: ModelConfig, p, x):
    """Full-sequence block of the ssm kind."""
    _require_ssm(cfg, "_block_full")
    p = _cast_params(cfg, p)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + mamba2_forward(h, p["mamba"], cfg.ssm, cfg.d_model)


def _head(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


# ============================================================ full forward

def forward(cfg: ModelConfig, params, tokens=None, embeds=None):
    """Training/prefill forward -> (logits [B, S, V], None); the second
    entry is the reference's per-layer caches, which the ssm family does
    not collect."""
    _require_ssm(cfg, "forward")
    x = params["embed"][tokens] if embeds is None else embeds
    x = x.to(dtype_of(cfg.compute_dtype))
    for i in range(cfg.n_layers):
        x = _block_full(cfg, _layer(params["ssm"], i), x)
    return _head(cfg, params, x), None


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
               dtype=torch.bfloat16, *, device="cuda") -> DecodeCache:
    """The decode cache at position 0. For the ssm family it is the stacked
    Mamba-2 state and does not grow with ``max_seq``."""
    _require_ssm(cfg, "init_cache")
    return DecodeCache(pos=0, layers={"ssm": _stacked_ssm_state(
        cfg, cfg.n_layers, batch, dtype, device)})


def _stacked_ssm_state(cfg, n, batch, dtype, device) -> Mamba2State:
    st = mamba2_init_state(cfg.ssm, cfg.d_model, batch, dtype, device)
    return Mamba2State(*(a.expand(n, *a.shape).clone() for a in st))


def decode_step(cfg: ModelConfig, params, token_or_embed: torch.Tensor,
                cache: DecodeCache):
    """One decode step: token [B] (or embed [B, D]) -> (logits [B, V],
    cache). The input cache is left as it is."""
    _require_ssm(cfg, "decode_step")
    if token_or_embed.dim() == 1:
        x = params["embed"][token_or_embed]
    else:
        x = token_or_embed
    x = x.to(dtype_of(cfg.compute_dtype))
    x, states = _decode_scan_ssm(cfg, params["ssm"], x, cache.layers["ssm"],
                                 cache.pos)
    layers = dict(cache.layers, ssm=states)
    return _head(cfg, params, x), DecodeCache(pos=cache.pos + 1,
                                              layers=layers)


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
