"""Plain PyTorch version of the flash attention kernel."""

from __future__ import annotations

from typing import Optional

import torch


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale: Optional[float] = None
            ) -> torch.Tensor:
    """q: [B, Hq, Lq, D]; k/v: [B, Hkv, Lk, D]; Hq % Hkv == 0 (GQA).

    Softmax in f32 whatever the input dtype (as the kernel does); the
    queries are the last Lq positions of the Lk-long sequence. Result in
    q's dtype."""
    _, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} are not a multiple of kv heads {hkv}")
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        kpos = torch.arange(lk, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, float("-inf"))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vx).to(q.dtype)
