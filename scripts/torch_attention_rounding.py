"""How far rounding alone moves B2 (flash attention), per (batch, q head),
at its main paths' shapes.

    PYTHONPATH=src python scripts/torch_attention_rounding.py [--heads 8]

Runs on the CPU with the port's plain versions only (no kernel), on seeded
normal inputs, causal and full:

- bf16 at yi-6b's prefill layout (q [1, 32, 4096, 128] over 4 KV heads;
  the first ``--heads`` q heads): ``mha_ref`` (f32 math, the result
  rounded once) and ``mha_bf16_p_ref`` (the bf16 kernel's arithmetic: P
  rounded to bf16 before P·V) against an f64 oracle, and against each
  other (the kernel's one extra rounding, in plain form);
- f32 at the attention chain's task ([1, 1, 4096, 128]): ``mha_ref`` and
  the f32 kernel's split ranges merged as the kernel merges them (the plan
  of a 132-SM card, one block per SM) against the oracle and each other.

Each pair is printed as the largest over (batch, q head) of max|a - b| /
max|b| within that head's [L, D] (``per head``), and as max|a - b| /
max(1, max|b|) over the tensor (``whole``): the two measures
``chip_smoke.py`` holds B2 to.
"""

import argparse

import torch

from repro_torch.kernels.flash_attention import mha_bf16_p_ref, mha_ref
from repro_torch.kernels.flash_attention.flash_attention import split_plan

L, D = 4096, 128
HQ, HKV = 32, 4
BQ, BK, SLOTS = 128, 64, 132      # the f32 kernel's tiles; one H100 wave


def gaps(a, b):
    """(per head, whole) as above, b the reference."""
    a, b = a.double().flatten(2), b.double().flatten(2)
    err = (a - b).abs()
    return (float((err.amax(-1) / b.abs().amax(-1)).max()),
            float(err.max() / max(1.0, float(b.abs().max()))))


def oracle(q, k, v, causal):
    """f64 softmax(q kᵀ / sqrt(D) + mask) v, one KV head per q head."""
    q, k, v = q.double(), k.double(), v.double()
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        lq, lk = q.shape[2], k.shape[2]
        pos = torch.arange(lq)[:, None] + lk - lq
        s = s.masked_fill(torch.arange(lk)[None, :] > pos, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", s.softmax(-1), v)


def split_merge(q, k, v, causal):
    """The f32 kernel's arithmetic in plain form: each query tile's KV walk
    cut into the plan's ranges, each range's (m, l, acc) in f32, merged
    with weights exp(m - max) / sum over the ranges."""
    lq, lk = q.shape[2], k.shape[2]
    plan = split_plan(lq, lk, causal, BQ, BK, SLOTS)
    scale = q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    for t, (first, count) in enumerate(plan.tiles):
        rows = slice(t * BQ, min(lq, (t + 1) * BQ))
        pos = torch.arange(rows.start, rows.stop)[:, None] + lk - lq
        parts = []
        for _, t0, t1 in plan.items[first:first + count]:
            keys = torch.arange(t0 * BK, min(lk, t1 * BK))
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows],
                             k[:, :, keys]) * scale
            if causal:
                s = s.masked_fill(keys[None, :] > pos, -1e30)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, keys])))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        den = sum(torch.exp(m - mx) * l for m, l, _ in parts)
        out[:, :, rows] = sum(torch.exp(m - mx) / den * acc
                              for m, _, acc in parts)
    return out


def show(label, pairs):
    print(label + ": " + "; ".join(
        f"{name} per head {h:.3e}, whole {w:.3e}" for name, (h, w) in pairs),
        flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heads", type=int, default=8,
                    help="q heads of yi-6b's layer to measure (<= 32)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    gen = torch.Generator().manual_seed(args.seed)
    k_all = torch.randn((1, HKV, L, D), generator=gen).bfloat16()
    v_all = torch.randn((1, HKV, L, D), generator=gen).bfloat16()
    q_all = torch.randn((1, HQ, L, D), generator=gen).bfloat16()
    for causal in (True, False):
        worst = {}
        for h in range(args.heads):
            kv = h // (HQ // HKV)
            q, k, v = (q_all[:, h:h + 1], k_all[:, kv:kv + 1],
                       v_all[:, kv:kv + 1])
            exact = oracle(q, k, v, causal)
            plain = mha_ref(q, k, v, causal=causal)
            p_bf16 = mha_bf16_p_ref(q, k, v, causal=causal)
            for name, (a, b) in {"plain-oracle": (plain, exact),
                                 "bf16P-oracle": (p_bf16, exact),
                                 "bf16P-plain": (p_bf16, plain)}.items():
                h_gap, w_gap = gaps(a, b)
                old = worst.get(name, (0.0, 0.0))
                worst[name] = (max(old[0], h_gap), max(old[1], w_gap))
        show(f"bf16 yi-6b layer, {args.heads} q heads, "
             f"{'causal' if causal else 'full'}", worst.items())
    x = torch.randn((1, 1, L, D), generator=gen)
    for causal in (True, False):
        exact = oracle(x, x, x, causal)
        plain = mha_ref(x, x, x, causal=causal)
        merged = split_merge(x, x, x, causal)
        show(f"f32 chain task, {'causal' if causal else 'full'}",
             (("plain-oracle", gaps(plain, exact)),
              ("split-oracle", gaps(merged, exact)),
              ("split-plain", gaps(merged, plain))))


if __name__ == "__main__":
    main()
