"""How much a deep random-weight mamba2 amplifies rounding differences.

    PYTHONPATH=src python scripts/torch_mamba2_rounding.py [--layers 48]

Runs on the CPU with the port's plain versions only (no kernel): a
mamba2-1.3b-shaped model of ``--layers`` layers at ``--d-model`` (d_state
64, heads of 64, seeded weights), in f32 and in bf16 compute, and prints
two comparisons of last-position logits as max|a - b| / max|b| and argmax
agreement:

- prefill over the prompt against feeding it token by token through
  ``decode_step`` (the model's invariant);
- prefill with the chunked SSD against prefill with the token recurrence
  (one function, sums in other orders).

Both pairs compute the same function, so the gaps are roundings carried
through the layers. ``chip_smoke.py`` sets its model tolerances from them.
"""

import argparse
import dataclasses

import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels.ssd_scan import ssd_ref
from repro_torch.models import mamba2
from repro_torch.models import transformer as tfm


def gap(a, b):
    a, b = a.float(), b.float()
    return (float((a - b).abs().max() / b.abs().max()),
            float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    base = reduced(get_config("mamba2-1.3b"), n_layers=args.layers,
                   d_model=args.d_model, vocab_size=2048)
    base = dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, d_state=64, head_dim=64))
    params = tfm.init_params(base, seed=0, device="cpu")
    toks = torch.randint(0, base.vocab_size, (args.batch, args.seq),
                         generator=torch.Generator().manual_seed(1))
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        with torch.inference_mode():
            chunked = tfm.prefill(cfg, params, tokens=toks)
            cache = tfm.init_cache(cfg, args.batch, args.seq,
                                   dtype=getattr(torch, dtype), device="cpu")
            for t in range(args.seq):
                decoded, cache = tfm.decode_step(cfg, params, toks[:, t],
                                                 cache)
            kernel, mamba2.ssd = mamba2.ssd, (
                lambda *ops, q_chunk=128: ssd_ref(*ops))
            try:
                recurrent = tfm.prefill(cfg, params, tokens=toks)
            finally:
                mamba2.ssd = kernel
        print(f"{dtype:<9} {args.layers} layers d_model {args.d_model}: "
              "prefill vs decode %.3e (argmax %.2f); chunked vs recurrence "
              "SSD %.3e (argmax %.2f)" % (*gap(decoded, chunked),
                                          *gap(chunked, recurrent)))


if __name__ == "__main__":
    main()
