"""Plain PyTorch versions of the Mamba-2 SSD scan.

State h_t [N, P] per (batch, head):

    h_t = exp(dt_t · A_h) · h_{t-1} + B_t ⊗ (dt_t · x_t)
    y_t = C_t · h_t  (+ D_h · x_t)

``ssd_ref`` runs this token by token and stays the independent oracle;
``ssd_chunked_ref`` runs the chunked algorithm of the kernel and is the
kernel's plain version.
"""

from __future__ import annotations

from typing import Optional

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor,
            d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, L, H, P]; dt: [B, L, H]; a: [H] (negative); b/c: [B, L, G, N]
    with H % G == 0; d: [H] or None -> y: [B, L, H, P] in x's dtype."""
    bsz, l, h, p = x.shape
    n = b.shape[3]
    rep = h // b.shape[2]
    bx = b.repeat_interleave(rep, dim=2).float()      # [B, L, H, N]
    cx = c.repeat_interleave(rep, dim=2).float()
    da = dt.float() * a.float()[None, None, :]        # [B, L, H]
    xdt = (x * dt[..., None]).float()                 # in x's dtype, as repro
    hstate = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        hstate = (torch.exp(da[:, t])[..., None, None] * hstate
                  + bx[:, t, :, :, None] * xdt[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", cx[:, t], hstate))
    y = torch.stack(ys, dim=1)
    if d is not None:
        y = y + x.float() * d.float()[None, None, :, None]
    return y.to(x.dtype)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor,
                    d: Optional[torch.Tensor] = None, *,
                    q_chunk: int = 128) -> torch.Tensor:
    """The chunked SSD algorithm (the kernel's math) in plain PyTorch: L/Q
    sequential steps of chunk-level products instead of an L-step token
    recurrence. L must be a multiple of ``min(q_chunk, L)``. dt·x and the
    skip are formed in f32 and y is rounded once to x's dtype."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    q = min(q_chunk, l)
    if l % q:
        raise ValueError(f"ssd_chunked_ref: L = {l} is not a multiple of the "
                         f"chunk {q}")
    nc = l // q
    bxc = b.repeat_interleave(rep, dim=2).float().reshape(bsz, nc, q, h, n)
    cxc = c.repeat_interleave(rep, dim=2).float().reshape(bsz, nc, q, h, n)
    da = (dt.float() * a.float()[None, None, :]).reshape(bsz, nc, q, h)
    xdt = (x.float() * dt.float()[..., None]).reshape(bsz, nc, q, h, p)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for ci in range(nc):
        da_c, b_c, c_c, xdt_c = da[:, ci], bxc[:, ci], cxc[:, ci], xdt[:, ci]
        cum = da_c.cumsum(dim=1)                                  # [B, q, H]
        diff = cum[:, :, None] - cum[:, None, :]                  # [B, i, j, H]
        # exp only where j <= i: above the diagonal the exponent is positive
        lmat = torch.exp(diff.masked_fill(~tri[None, :, :, None],
                                          float("-inf")))
        scores = torch.einsum("bihn,bjhn->bijh", c_c, b_c) * lmat
        y = torch.einsum("bijh,bjhp->bihp", scores, xdt_c)
        y = y + torch.einsum("bihn,bhnp->bihp",
                             c_c * torch.exp(cum)[..., None], state)
        decay_rest = torch.exp(cum[:, -1:, :] - cum)              # [B, q, H]
        state = (torch.exp(cum[:, -1, :])[..., None, None] * state
                 + torch.einsum("bjhn,bjhp->bhnp", b_c,
                                xdt_c * decay_rest[..., None]))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, l, h, p)
    if d is not None:
        y = y + x.float() * d.float()[None, None, :, None]
    return y.to(x.dtype)


def ssd_bf16_operands_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, c: torch.Tensor,
                          d: Optional[torch.Tensor] = None, *,
                          q_chunk: int = 128) -> torch.Tensor:
    """The chunk-parallel kernel's arithmetic in plain PyTorch: the same
    function as ``ssd_chunked_ref``, computed as the kernel computes it.
    Per chunk, C Bᵀ per group in f32; the scores (C Bᵀ) ⊙ L ⊙ dt_j; the
    chunk's own end state S = Bᵀ (x ⊙ dt ⊙ exp(cum_Q − cum)); the states H
    entering each chunk handed on in f32; y = scores · x + exp(cum) ⊙ (C H)
    + D x. For bf16 operands the scores, x ⊙ dt ⊙ exp(cum_Q − cum) and H
    are rounded to bf16 where they become operands of the tensor cores'
    products (B, C and x are used as stored; products and sums in f32) and
    y once at the end; for f32 operands nothing is rounded but y. Any L:
    a ragged last chunk is padded with dt = x = B = C = 0 rows."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    q = min(q_chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if x.dtype == torch.bfloat16:
        def rnd(t):
            return t.to(torch.bfloat16).float()
    else:
        def rnd(t):
            return t

    def chunks(t):      # [B, L, ...] -> [B, nc, q, ...] in f32, zero-padded
        t = t.float()
        t = torch.cat([t, t.new_zeros((bsz, pad) + t.shape[2:])], dim=1)
        return t.reshape((bsz, nc, q) + t.shape[2:])

    xc, dtc, bc, cc = chunks(x), chunks(dt), chunks(b), chunks(c)
    cum = (dtc * a.float()[None, None, None, :]).cumsum(dim=2)    # [B,nc,q,H]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for ci in range(nc):
        cu, dtk, xk = cum[:, ci], dtc[:, ci], xc[:, ci]
        cb = torch.einsum("bign,bjgn->bijg", cc[:, ci], bc[:, ci])
        cb = cb.repeat_interleave(rep, dim=3)                     # [B,i,j,H]
        lmat = torch.exp((cu[:, :, None] - cu[:, None, :]).masked_fill(
            ~tri[None, :, :, None], float("-inf")))
        scores = rnd(cb * lmat * dtk[:, None, :, :])
        y = torch.einsum("bijh,bjhp->bihp", scores, xk)
        cx = cc[:, ci].repeat_interleave(rep, dim=2)              # [B,q,H,N]
        y = y + torch.exp(cu)[..., None] * torch.einsum(
            "bihn,bhnp->bihp", cx, rnd(state))
        w = dtk * torch.exp(cu[:, -1:, :] - cu)                   # [B,q,H]
        s_c = torch.einsum("bjhn,bjhp->bhnp",
                           bc[:, ci].repeat_interleave(rep, dim=2),
                           rnd(xk * w[..., None]))
        state = torch.exp(cu[:, -1, :])[..., None, None] * state + s_c
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, nc * q, h, p)[:, :l]
    if d is not None:
        y = y + x.float() * d.float()[None, None, :, None]
    return y.to(x.dtype)
