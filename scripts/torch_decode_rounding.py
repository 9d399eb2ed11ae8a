"""How far rounding alone moves single-token decode attention, per
(batch, q head) row, at yi-6b's decode layer over a 32 768-position cache.

    PYTHONPATH=src python scripts/torch_decode_rounding.py [--chunk 2560]

Runs on the CPU with the port's plain version only (no kernel), one batch
row at a time (q [1, 32, 128], K/V [1, 4, 32768, 128], the ragged lengths
of ``chip_smoke.py``'s ``DECODE_CELL_LEN``, seeded normal values), with f32
and with bf16 operands. For each it prints, as the largest over rows of
max|a - b| / max|b| within the row:

- ``decode_ref`` (f32 math) against an f64 oracle on the same operands;
- a split-cache merge (f32 partials over ranges of ``--chunk`` positions,
  merged as B4 merges them) against the oracle;
- the split-cache merge against ``decode_ref``: one function, sums in
  other orders, the plain counterpart of B4's CUDA-core kernel against its
  plain version;
- ``decode_bf16_p_ref`` (P rounded to bf16 before P·V, as B4's
  tensor-core kernel rounds it) against ``decode_ref``, per row and, as
  ``ring-plain whole``, over the whole output as max|a - b| / max(1,
  max|b|) (the measure of ``chip_smoke.py``'s whole-output check).

A long row averages thousands of values of either sign, so its outputs are
small against the terms summed; the per-row gap shows how much of a row's
own size rounding takes. ``chip_smoke.py`` sets B4's per-row tolerance
from it.
"""

import argparse

import torch

from repro_torch.kernels.decode_attention import decode_bf16_p_ref, decode_ref

HQ, HKV, S, D = 32, 4, 32768, 128
LENS = (32768, 32751, 17000, 1, 4096, 65, 64, 30000)


def row_gap(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def oracle(q, k, v, n):
    """f64 softmax(q K^T / sqrt(D)) V over the first n positions, the q
    heads grouped over their KV head (no repeated copies)."""
    qg = q.double().view(1, HKV, HQ // HKV, D)
    k, v = k[:, :, :n].double(), v[:, :, :n].double()
    p = torch.einsum("bkgd,bksd->bkgs", qg, k).mul(D ** -0.5).softmax(-1)
    return torch.einsum("bkgs,bksd->bkgd", p, v).reshape(1, HQ, D)


def split_merge(q, k, v, n, chunk):
    """f32 partials (max, sum, unnormalised output) over ranges of
    ``chunk`` live positions, merged by their maxima, as B4 does."""
    qg = q.float().view(1, HKV, HQ // HKV, D)
    parts = []
    for lo in range(0, n, chunk):
        kk = k[:, :, lo:min(n, lo + chunk)].float()
        vv = v[:, :, lo:min(n, lo + chunk)].float()
        sc = torch.einsum("bkgd,bksd->bkgs", qg, kk) * D ** -0.5
        m = sc.amax(-1, keepdim=True)
        e = torch.exp(sc - m)
        parts.append((m, e.sum(-1, keepdim=True),
                      torch.einsum("bkgs,bksd->bkgd", e, vv)))
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = sum(p[1] * torch.exp(p[0] - m) for p in parts)
    o = sum(p[2] * torch.exp(p[0] - m) for p in parts)
    return (o / l).reshape(1, HQ, D).to(q.dtype)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk", type=int, default=2560)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    gen = torch.Generator().manual_seed(args.seed)
    for dtype in (torch.float32, torch.bfloat16):
        worst = {"plain-oracle": 0.0, "split-oracle": 0.0, "split-plain": 0.0,
                 "ring-plain": 0.0, "ring-plain whole": 0.0}
        for n in LENS:
            q = torch.randn((1, HQ, D), generator=gen).to(dtype)
            k = torch.randn((1, HKV, S, D), generator=gen).to(dtype)
            v = torch.randn((1, HKV, S, D), generator=gen).to(dtype)
            kv_len = torch.tensor([n], dtype=torch.int32)
            plain = decode_ref(q, k, v, kv_len)
            split = split_merge(q, k, v, n, args.chunk)
            want = oracle(q, k, v, n)
            if dtype == torch.bfloat16:        # one rounding of the result
                want = want.to(dtype)
            gaps = {"plain-oracle": row_gap(plain, want),
                    "split-oracle": row_gap(split, want),
                    "split-plain": row_gap(split, plain)}
            ring = decode_bf16_p_ref(q, k, v, kv_len)
            gaps["ring-plain"] = row_gap(ring, plain)
            gaps["ring-plain whole"] = float(
                (ring.double() - plain.double()).abs().max()
                / max(1.0, float(plain.double().abs().max())))
            print(f"{str(dtype)[6:]:<9} kv_len {n:>5}: " + ", ".join(
                f"{key} {val:.2e}" for key, val in gaps.items()), flush=True)
            for key, val in gaps.items():
                worst[key] = max(worst[key], val)
        print(f"{str(dtype)[6:]:<9} largest per-row gaps: " + ", ".join(
            f"{key} {val:.2e}" for key, val in worst.items()), flush=True)


if __name__ == "__main__":
    main()
