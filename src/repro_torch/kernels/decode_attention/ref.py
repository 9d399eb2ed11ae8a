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


def decode_bf16_p_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tensor-core kernel's rounding in plain PyTorch: the same function
    as ``decode_ref``, computed as the kernel computes it. An online softmax
    in f32 over 16-position slices (each warp of the kernel walks 16
    positions of a tile), dead positions at probability 0; for bf16
    operands P is rounded to bf16 before P·V (the one rounding the tensor
    cores add; products and sums in f32) while l sums the unrounded P; the
    result rounded to q's dtype once. For f32 operands nothing is rounded:
    it is ``decode_ref`` with its sums in another order."""
    _, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    qf = q.float()
    b = q.shape[0]
    live = (torch.arange(s, device=q.device)[None, :]
            < (torch.full((b,), s, device=q.device) if kv_len is None
               else kv_len.to(q.device))[:, None])[:, None, :]
    m = torch.full((b, hq, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, hq, 1), device=q.device)
    acc = torch.zeros((b, hq, d), device=q.device)
    bs = 16
    for s0 in range(0, s, bs):
        sc = torch.einsum("bhd,bhsd->bhs", qf, kx[:, :, s0:s0 + bs]) * d ** -0.5
        sc = sc.masked_fill(~live[:, :, s0:s0 + bs], float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(sc - base)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if q.dtype == torch.bfloat16:
            p = p.to(torch.bfloat16).float()
        acc = alpha * acc + torch.einsum("bhs,bhsd->bhd", p,
                                         vx[:, :, s0:s0 + bs])
        m = m_new
    return (acc / l).to(q.dtype)
