"""Serving driver (PyTorch port): prefill a batch of prompts, then batched
greedy decode against the KV cache (GQA / MLA-latent / Mamba-state per
family).

The port's counterpart of ``examples/serve_lm.py``; on ``cuda`` (the
decode attention kernel) unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_lm.py --arch yi-6b --tokens 32
  PYTHONPATH=src python examples/torch_serve_lm.py --arch mamba2-1.3b \
      --tokens 64 --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tfm
from repro_torch.serve.decode import make_serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve_lm: no CUDA device (pass --device cpu to run "
                         "on the CPU)")

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    print(f"serving {cfg.name} ({cfg.n_params() / 1e6:.1f}M params, "
          f"family={cfg.family}) on {device}")

    b = args.batch
    with torch.inference_mode():
        params = tfm.init_params(cfg, seed=0, device=device)
        enc_out = None
        if cfg.family == "encdec":
            enc_out = tuple(torch.zeros(
                (cfg.n_layers, b, cfg.n_kv_heads, args.prompt_len,
                 cfg.head_dim), dtype=torch.bfloat16, device=device)
                for _ in range(2))
        cache = tfm.init_cache(cfg, b, args.max_seq, enc_out=enc_out,
                               device=device)
        serve_step = make_serve_step(cfg)

        # "prefill" by decoding the prompt tokens into the cache (the
        # simple path; the bulk prefill runs in make_prefill_step)
        rng = np.random.default_rng(0)
        prompt = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (b, args.prompt_len))).to(device)
        tok = prompt[:, 0]
        t0 = time.perf_counter()
        for i in range(1, args.prompt_len):
            _, _, cache = serve_step(params, tok, cache)
            tok = prompt[:, i]
        print(f"prefill({args.prompt_len} tokens): "
              f"{(time.perf_counter() - t0) * 1e3:.0f} ms")

        generated = []
        t0 = time.perf_counter()
        for _ in range(args.tokens):
            tok, logits, cache = serve_step(params, tok, cache)
            generated.append(tok)
        gen = torch.stack(generated, 1).cpu()      # waits for the device
        dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} tokens x batch {b}: "
          f"{b * args.tokens / dt:.1f} tok/s")
    print("sample:", gen[0][:16].tolist())
    assert torch.isfinite(logits.float()).all()


if __name__ == "__main__":
    main()
