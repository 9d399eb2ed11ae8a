"""Serving driver (PyTorch port): prefill a batch of prompts, then batched
greedy decode against the KV cache (GQA / MLA-latent / Mamba-state per
family).

The port's counterpart of ``examples/serve_lm.py``; on ``cuda`` (the
decode attention kernel) unless ``--device cpu``. With ``--ranks N`` every
family serves tensor-parallel on N rank processes: a (N / model, model)
("data", "model") mesh, model = min(4, N), each rank holding its shard of
the weights and of the cache (``repro_torch.dist.tensor_parallel``);
rank 0 prints.

  PYTHONPATH=src python examples/torch_serve_lm.py --arch yi-6b --tokens 32
  PYTHONPATH=src python examples/torch_serve_lm.py --arch mamba2-1.3b \
      --tokens 64 --device cpu
  PYTHONPATH=src python examples/torch_serve_lm.py --arch yi-6b \
      --ranks 2 --device cpu
  PYTHONPATH=src python examples/torch_serve_lm.py --arch \
      deepseek-v3-671b --ranks 4 --device cpu
  PYTHONPATH=src python examples/torch_serve_lm.py --arch zamba2-1.2b \
      --ranks 4 --device cpu
"""

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.dist.ctx import launch_mesh
from repro_torch.dist.ranks import spawn_ranks
from repro_torch.dist.sharding import batch_axis
from repro_torch.dist.tensor_parallel import (check_tp, init_shard_cache,
                                              init_shard_params)
from repro_torch.launch.mesh import make_dev_mesh
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
    ap.add_argument("--ranks", type=int, default=0, metavar="N",
                    help="tensor-parallel on N rank processes")
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
          f"family={cfg.family}) on {device}"
          + (f", {args.ranks} rank processes" if args.ranks else ""))
    if args.ranks:
        try:
            check_tp(cfg, make_dev_mesh(args.ranks,
                                        device="meta").shape["model"])
        except ValueError as exc:
            raise SystemExit(f"--ranks: {exc}")
        spawn_ranks(serve, args.ranks, args, cfg, device=device)
    else:
        serve(0, 1, args, cfg, device=device, ranks=False)


def serve(rank, world, args, cfg, *, device, ranks=True):
    """Prefill by decoding and the timed greedy tokens, on one process or
    on this rank of the mesh of ``world`` ranks (its rows of the batch,
    its shard of the weights and the cache); rank 0 prints."""
    b = args.batch
    mesh = (make_dev_mesh(world, device=device, group=dist.group.WORLD)
            if ranks else None)
    show = rank == 0
    with torch.inference_mode(), launch_mesh(mesh, global_batch=b):
        if ranks:
            params = init_shard_params(cfg, mesh, seed=0, device=device)
            cache = init_shard_cache(cfg, mesh, b, args.max_seq,
                                     device=device)
            rows = next(iter(cache.layers.values()))[0].shape[1]
            lo = mesh.coords["data"] * rows if batch_axis(mesh, b) else 0
        else:
            params = tfm.init_params(cfg, seed=0, device=device)
            enc_out = None
            if cfg.family == "encdec":
                enc_out = tuple(torch.zeros(
                    (cfg.n_layers, b, cfg.n_kv_heads, args.prompt_len,
                     cfg.head_dim), dtype=torch.bfloat16, device=device)
                    for _ in range(2))
            cache = tfm.init_cache(cfg, b, args.max_seq, enc_out=enc_out,
                                   device=device)
            lo, rows = 0, b
        serve_step = make_serve_step(cfg)

        # "prefill" by decoding the prompt tokens into the cache (the
        # simple path; the bulk prefill runs in make_prefill_step)
        rng = np.random.default_rng(0)
        prompt = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (b, args.prompt_len))[lo:lo + rows]).to(
                device)
        tok = prompt[:, 0]
        t0 = time.perf_counter()
        for i in range(1, args.prompt_len):
            _, _, cache = serve_step(params, tok, cache)
            tok = prompt[:, i]
        if show:
            print(f"prefill({args.prompt_len} tokens): "
                  f"{(time.perf_counter() - t0) * 1e3:.0f} ms")

        generated = []
        t0 = time.perf_counter()
        for _ in range(args.tokens):
            tok, logits, cache = serve_step(params, tok, cache)
            generated.append(tok)
        gen = torch.stack(generated, 1).cpu()      # waits for the device
        dt = time.perf_counter() - t0
    assert torch.isfinite(logits.float()).all()
    if show:
        print(f"decoded {args.tokens} tokens x batch {b}: "
              f"{b * args.tokens / dt:.1f} tok/s")
        print("sample:", gen[0][:16].tolist())


if __name__ == "__main__":
    main()
