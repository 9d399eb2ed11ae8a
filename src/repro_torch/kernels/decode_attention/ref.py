"""Plain PyTorch version of the decode attention kernel."""

from __future__ import annotations

from typing import Optional

import torch


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B, Hq, D] (one new token); k/v: [B, Hkv, S, D], Hq % Hkv == 0;
    optional kv_len [B] masks positions >= kv_len (a ragged cache).

    f32 math whatever the input dtype, the dead positions masked with -inf
    (a row with kv_len 0 gives NaN, as in the JAX package); result in q's
    dtype."""
    _, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kx) * d ** -0.5
    if kv_len is not None:
        live = (torch.arange(s, device=q.device)[None, None, :]
                < kv_len.to(q.device)[:, None, None])
        logits = logits.masked_fill(~live, float("-inf"))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhs,bhsd->bhd", probs, vx).to(q.dtype)
