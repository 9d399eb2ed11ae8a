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


def mha_bf16_p_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, bk: int = 128) -> torch.Tensor:
    """The bf16 kernel's rounding in plain PyTorch: the same function as
    ``mha_ref``, computed as the kernel computes it. An online softmax over
    ``bk``-key tiles in f32 (masked logits -1e30), P rounded to bf16 before
    P·V (the one rounding the tensor cores add; products and sums in f32),
    l summed from the unrounded P, the result rounded to q's dtype once."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    qf = q.float() * d ** -0.5
    qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    m = torch.full((b, hq, lq, 1), -1e30, device=q.device)
    l = torch.zeros((b, hq, lq, 1), device=q.device)
    acc = torch.zeros((b, hq, lq, d), device=q.device)
    for k0 in range(0, lk, bk):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kx[:, :, k0:k0 + bk])
        if causal:
            kpos = torch.arange(k0, min(lk, k0 + bk), device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
            vx[:, :, k0:k0 + bk])
        m = m_new
    return (acc / l).to(q.dtype)
