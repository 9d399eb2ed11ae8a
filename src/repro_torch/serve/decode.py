"""Serve steps: prefill (prompt forward) and decode (one token vs cache)."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import transformer as tfm


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return tfm.prefill(cfg, params, tokens=batch.get("tokens"),
                           embeds=batch.get("embeds"),
                           enc_embeds=batch.get("enc_embeds"))
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step with the greedy next token, so the step is a
    complete serving unit (logits never leave the device). Tokens are int64,
    torch's index type."""
    def serve_step(params, token, cache):
        logits, cache = tfm.decode_step(cfg, params, token, cache)
        next_token = torch.argmax(logits.float(), dim=-1)
        return next_token, logits, cache
    return serve_step
