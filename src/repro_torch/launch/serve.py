"""Serving launcher: seeded weights on one device and a batched greedy
decode loop.

    python -m repro_torch.launch.serve --arch yi-6b --batch 8 \
        --tokens 16 [--reduced] [--device cpu] [--host-devices N]

The JAX package's decode loop (``repro.launch.serve``): one warm-up step,
then ``--tokens`` timed steps from a fresh cache of ``--max-seq``
positions (bf16, donated to each step); prints tok/s and the first
sequence's tokens. Runs on ``cuda`` unless ``--device cpu``. Every
family runs: dense (yi-6b, qwen3-14b, starcoder2-3b, yi-34b), vlm
(llava-next-34b, fed token embeddings as the JAX launcher feeds it), moe
(grok-1-314b; deepseek-v3-671b with MLA's latent cache; their bf16
weights, 0.43 and 1.34 TB, fit one card only ``--reduced``), ssm
(mamba2-1.3b), hybrid (zamba2-1.2b) and encdec (seamless-m4t-large-v2,
whose cross-attention reads a cache of zeros [L, B, Hkv, max_seq, hd], as
the JAX launcher makes it: there is no encoder pass).

``--host-devices N`` serves under a logical mesh of N devices
(``launch/mesh.py``): (N / model, model) over ("data", "model") with model
= min(4, N), the production (16, 16) mesh from N = 256 on. As the
reference's launcher, it sets the batch axes (``batch_axis``) and builds
the cache with ``kv_head_pad`` replicated KV heads; an MoE arch then
routes each step's tokens in ``data_rows()`` dispatch rows.
"""

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="serve under a logical mesh of N devices")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import reduced as reduce_cfg
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.ctx import launch_mesh
    from repro_torch.dist.sharding import kv_head_pad
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.decode import make_serve_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device (pass --device cpu to run on "
                         "the CPU)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    mesh = (make_dev_mesh(args.host_devices, device=device)
            if args.host_devices else None)
    pad = kv_head_pad(cfg, mesh.shape["model"]) if mesh else 1
    print(f"device: {where}, arch={cfg.name}" + (
        f", mesh: {mesh.shape} (logical), kv_head_pad {pad}" if mesh
        else ""))
    with torch.inference_mode(), launch_mesh(mesh,
                                             global_batch=args.batch):
        params = tfm.init_params(cfg, seed=args.seed, device=device)
        enc_out = None
        if cfg.family == "encdec":
            enc_out = tuple(torch.zeros(
                (cfg.n_layers, args.batch, cfg.n_kv_heads, args.max_seq,
                 cfg.head_dim), dtype=torch.bfloat16, device=device)
                for _ in range(2))
        cache = tfm.init_cache(cfg, args.batch, args.max_seq, enc_out=enc_out,
                               device=device, kv_head_pad=pad)
        step = make_serve_step(cfg)
        tok = torch.ones((args.batch,), dtype=torch.int64, device=device)
        tok, _, cache = step(params, tok, cache)          # warm-up
        out = []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.tokens):
            tok, _, cache = step(params, tok, cache)
            out.append(tok)
        sample = torch.stack(out, 1)[0][:12].tolist()    # waits for the device
        dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} x batch {args.batch}: "
          f"{args.batch * args.tokens / dt:.1f} tok/s; sample {sample}")


if __name__ == "__main__":
    main()
