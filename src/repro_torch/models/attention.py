"""Attention: the GQA prefill and decode dispatch, and the plain chunked
attention (PyTorch).

The port of ``repro.models.attention``. MLA (``models/transformer.py``)
calls ``chunked_attention`` directly for its prefill, as the reference
does: its q and k are wider than v, which B2 does not take. Where the JAX
package runs its jnp versions everywhere off the TPU, the port sends CUDA
tensors to its hand-written kernels and CPU tensors to the plain versions:

- prefill: B2 ``flash_attention`` on CUDA, ``chunked_attention`` (the
  reference's online softmax over KV chunks) on the CPU; causal or not,
  Lq = Lk or not (the encdec family's cross-attention), with or without a
  sliding window (the hybrid family's shared block);
- decode: B4 ``decode_attention`` on CUDA, ``decode_ref`` on the CPU; over
  a cache, a ring (the hybrid's window) or the encoder's keys (encdec).

Neither falls back on CUDA tensors: the kernels launch or raise. The
kernels have no backward, so under grad (an operand that requires it) the
prefill takes ``chunked_attention`` on every device, as the reference
trains; each of its KV chunks then runs under ``torch.utils.checkpoint``,
as the reference's sits under ``jax.checkpoint``, so that no chunk's
scores are kept for the backward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels._build import needs_grad
from ..kernels.decode_attention import ops as decode_ops
from ..kernels.decode_attention.ref import decode_ref
from ..kernels.flash_attention import ops as flash_ops
from ..launch.flags import attn_chunk

NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, chunk: int = 1024,
                      window: int = 0) -> torch.Tensor:
    """q [B,Hq,Lq,D], k/v [B,Hkv,Lk,D] -> [B,Hq,Lq,D]; never materialises
    more than [*, Lq, chunk] scores. ``REPRO_ATTN_CHUNK`` overrides
    ``chunk``; Lk must be a multiple of it when longer."""
    chunk = attn_chunk() or chunk
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    group = hq // hkv
    scale = dh ** -0.5
    if lk <= chunk:
        return _attn_block(q, k, v, causal, window, scale, group)

    n_chunks = lk // chunk
    assert lk % chunk == 0, (lk, chunk)
    qf = q.float()
    qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    m = torch.full((b, hq, lq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, lq, 1), device=q.device)
    acc = torch.zeros((b, hq, lq, dv), device=q.device)
    remat = needs_grad(q, k, v)
    for ci in range(n_chunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        args = (m, l, acc, qf, k[:, :, sl], v[:, :, sl], qpos, ci * chunk,
                causal, window, scale, group)
        m, l, acc = (checkpoint(_chunk_step, *args, use_reentrant=False,
                                preserve_rng_state=False)
                     if remat else _chunk_step(*args))
    return (acc / l).to(q.dtype)


def _chunk_step(m, l, acc, qf, kc, vc, qpos, k0: int, causal, window,
                scale, group):
    """One KV chunk of the online softmax: the running (max, sum, acc) of
    the queries against keys ``k0 .. k0 + chunk``."""
    chunk = kc.shape[2]
    kx = kc.repeat_interleave(group, dim=1).float()
    vx = vc.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kx) * scale
    kpos = k0 + torch.arange(chunk, device=qf.device)[None, :]
    mask = torch.ones((qf.shape[2], chunk), dtype=torch.bool,
                      device=qf.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l = alpha * l + p.sum(-1, keepdim=True)
    acc = alpha * acc + torch.einsum("bhqk,bhkd->bhqd", p, vx)
    return m_new, l, acc


def _attn_block(q, k, v, causal, window, scale, group):
    lq, lk = q.shape[2], k.shape[2]
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    kpos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full-sequence GQA attention of ``_gqa_full``: B2 on CUDA tensors
    (read through their strides, no copies; the window too),
    ``chunked_attention`` on CPU tensors and under grad (B2 has no
    backward)."""
    if q.device.type != "cuda" or needs_grad(q, k, v):
        return chunked_attention(q, k, v, causal=causal, window=window)
    return flash_ops.attention(q, k, v, causal=causal, window=window)


def decode_attention_host(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Single-token decode against a cache: B4 on CUDA tensors,
    ``decode_ref`` on CPU tensors (``decode_ops.decode``, the kernel's
    wrapper, picks by device). kv_len >= 1. On the meta device (the dry
    run's trace) the plain version: there are shapes and work to count,
    no values."""
    if q.device.type == "meta":
        return decode_ref(q, k, v, kv_len)
    return decode_ops.decode(q, k, v, kv_len)


__all__ = ["chunked_attention", "decode_attention_host", "prefill_attention"]
