"""How far the chunk-parallel SSD kernel's bf16 operand roundings move its
result, whole and per (batch, head), at mamba2-1.3b's layer at prefill.

    PYTHONPATH=src python scripts/torch_ssd_rounding.py [--batch 4]

Runs on the CPU with the port's plain versions only (no kernel): x [B,
2048, 64, 64], dt [B, 2048, 64], B/C [B, 2048, 1, 128] made as
``chip_smoke.py``'s ``ssd_operands`` makes them (seeded normal values), at
chunks of 128 (the model's) and 256 (``REPRO_SSD_CHUNK=256``), with f32 and
with bf16 operands. For each it prints ``ssd_bf16_operands_ref`` (the
kernel's arithmetic: for bf16 the scores, x ⊙ dt ⊙ exp(cum_Q − cum) and the
states entering each chunk rounded to bf16 where they become tensor-core
operands; for f32 nothing but the order of the sums) against
``ssd_chunked_ref`` (the kernel's plain version):

- ``whole``: max|a - b| / max(1, max|b|) over the output, the measure of
  ``chip_smoke.py``'s whole-output check;
- ``per row``: the largest over (batch, head) of max|a - b| / max|b| within
  that head's [L, P], each head held to its own size.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` set B3's per-(batch,
head) tolerance from these numbers.
"""

import argparse

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_bf16_operands_ref, ssd_chunked_ref

L, H, P, G, N = 2048, 64, 64, 1, 128


def gaps(got, want):
    """(whole, per row) of ``got`` against ``want``, both [B, L, H, P]."""
    got, want = got.double(), want.double()
    whole = float((got - want).abs().max() / max(1.0, float(want.abs().max())))
    diff = (got - want).abs().transpose(1, 2).flatten(2).amax(-1)
    size = want.abs().transpose(1, 2).flatten(2).amax(-1)
    return whole, float((diff / size).max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    gen = torch.Generator().manual_seed(args.seed)

    def randn(*s):
        return torch.randn(s, generator=gen)

    b = args.batch
    base = (randn(b, L, H, P), F.softplus(randn(b, L, H)) * 0.1,
            -torch.exp(randn(H) * 0.5), randn(b, L, G, N) * 0.5,
            randn(b, L, G, N) * 0.5, torch.full((H,), 0.5))
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, a, bm, cm, d = base
        ops = (x.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype), d)
        for q in (128, 256):
            kernel = ssd_bf16_operands_ref(*ops, q_chunk=q)
            plain = ssd_chunked_ref(*ops, q_chunk=q)
            whole, row = gaps(kernel, plain)
            print(f"{str(dtype)[6:]:<9} Q {q}: kernel arithmetic vs "
                  f"ssd_chunked_ref: whole {whole:.2e}, per row {row:.2e}",
                  flush=True)


if __name__ == "__main__":
    main()
