"""Plain PyTorch version of the flash attention kernel."""

from __future__ import annotations

from typing import Optional

import torch


def _live(lq: int, lk: int, k0: int, k1: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """[Lq, k1 - k0] bool: the keys k0 .. k1-1 that each query keeps,
    query i at position Lk - Lq + i: not after it with ``causal``, and
    fewer than ``window`` positions before it with a window, as the JAX
    package's ``chunked_attention`` masks."""
    qpos = torch.arange(lq, device=device)[:, None] + (lk - lq)
    kpos = torch.arange(k0, k1, device=device)[None, :]
    live = torch.ones((lq, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        live &= kpos <= qpos
    if window:
        live &= kpos > qpos - window
    return live


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale: Optional[float] = None,
            window: int = 0) -> torch.Tensor:
    """q: [B, Hq, Lq, D]; k/v: [B, Hkv, Lk, D]; Hq % Hkv == 0 (GQA).

    Softmax in f32 whatever the input dtype (as the kernel does); the
    queries are the last Lq positions of the Lk-long sequence; a ``window``
    > 0 masks the keys ``window`` or more positions before a query. Result
    in q's dtype."""
    _, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} are not a multiple of kv heads {hkv}")
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    # one [B, Hq, Lq, Lk] buffer, updated in place (a long window's scores
    # take tens of GB at the models' lengths)
    probs = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx).mul_(scale)
    if causal or window:
        probs.masked_fill_(~_live(lq, lk, 0, lk, causal, window, q.device),
                           float("-inf"))
    probs.sub_(probs.amax(dim=-1, keepdim=True)).exp_()
    probs.div_(probs.sum(dim=-1, keepdim=True))
    return torch.einsum("bhqk,bhkd->bhqd", probs, vx).to(q.dtype)


def mha_bf16_p_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, bk: int = 128,
                   window: int = 0) -> torch.Tensor:
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
    m = torch.full((b, hq, lq, 1), -1e30, device=q.device)
    l = torch.zeros((b, hq, lq, 1), device=q.device)
    acc = torch.zeros((b, hq, lq, d), device=q.device)
    for k0 in range(0, lk, bk):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kx[:, :, k0:k0 + bk])
        if causal or window:
            s = s.masked_fill(~_live(lq, lk, k0, min(lk, k0 + bk), causal,
                                     window, q.device), -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
            vx[:, :, k0:k0 + bk])
        m = m_new
    return (acc / l).to(q.dtype)
