"""Meta-device stand-ins for every model input, with their sharding specs.

The port of ``repro.launch.specs``: where the reference builds
``ShapeDtypeStruct``s, the port builds tensors on the ``meta`` device —
shapes and dtypes, no allocation (the dry run's contract).

``input_specs(cfg, cell, mesh)`` returns (args, arg_specs) for the step
kind, the specs sanitized against the mesh:
- train:   (params, opt_state, batch)          -> train_step
- prefill: (params, batch)                     -> prefill_step
- decode:  (params, token, cache)              -> serve_step
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeCell
from ..dist.sharding import (P, batch_axis, cache_specs, kv_head_pad,
                             param_specs, sanitize_specs)
from ..models import transformer as tfm
from ..train.optimizer import make_optimizer, opt_state_specs


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh):
    """(batch dict of meta tensors, batch dict of PartitionSpecs)."""
    b, s = cell.global_batch, cell.seq_len
    bn = batch_axis(mesh, b)
    batch: Dict[str, Any] = {}
    spec: Dict[str, Any] = {}
    if cfg.embed_inputs and cfg.family != "encdec":
        batch["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        spec["embeds"] = P(bn, None, None)
    elif cfg.family == "encdec":
        batch["enc_embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        spec["enc_embeds"] = P(bn, None, None)
        batch["tokens"] = _meta((b, s), torch.int32)
        spec["tokens"] = P(bn, None)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
        spec["tokens"] = P(bn, None)
    if cell.kind == "train":
        batch["labels"] = _meta((b, s), torch.int32)
        spec["labels"] = P(bn, None)
    return batch, spec


def abstract_state(cfg: ModelConfig):
    """(params, optimizer state) of ``cfg`` on the meta device."""
    params = tfm.abstract_params(cfg)
    init_opt, _ = make_optimizer(cfg.optimizer)
    return params, init_opt(params)


def input_specs(cfg: ModelConfig, cell: ShapeCell, mesh
                ) -> Tuple[tuple, tuple]:
    """-> (abstract_args, arg_partition_specs) for the cell's step kind."""
    model_axis = mesh.shape["model"]
    params, opt = abstract_state(cfg)
    p_specs = sanitize_specs(param_specs(cfg, model_axis=model_axis),
                             params, mesh)
    bn = batch_axis(mesh, cell.global_batch)

    if cell.kind == "train":
        batch, b_spec = batch_specs(cfg, cell, mesh)
        o_specs = sanitize_specs(
            opt_state_specs(p_specs, cfg.optimizer, params), opt, mesh)
        return (params, opt, batch), (p_specs, o_specs, b_spec)

    if cell.kind == "prefill":
        batch, b_spec = batch_specs(cfg, cell, mesh)
        return (params, batch), (p_specs, b_spec)

    # decode: one new token against a seq_len-deep cache
    b = cell.global_batch
    enc_out = None
    if cfg.family == "encdec":
        shape = (cfg.n_layers, b, cfg.n_kv_heads, cell.seq_len, cfg.head_dim)
        enc_out = (_meta(shape, torch.bfloat16), _meta(shape, torch.bfloat16))
    cache = tfm.init_cache(cfg, b, cell.seq_len, enc_out=enc_out,
                           device="meta",
                           kv_head_pad=kv_head_pad(cfg, model_axis))
    c_specs = sanitize_specs(
        cache_specs(cfg, cache, bn, model_axis=model_axis), cache, mesh)
    token = _meta((b,), torch.int32)
    return (params, token, cache), (p_specs, P(bn), c_specs)


__all__ = ["abstract_state", "batch_specs", "input_specs"]
