"""Serving launcher: seeded weights on one device and a batched greedy
decode loop.

    python -m repro_torch.launch.serve --arch yi-6b --batch 8 \
        --tokens 16 [--reduced] [--layers N] [--device cpu] \
        [--host-devices N [--ranks]]

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

``--ranks`` lays that (N / model, model) mesh on N rank processes
(``dist.ranks.spawn_ranks``; on ``cuda`` they share the card): each rank
draws only its tensor-parallel shard of the weights
(``dist.tensor_parallel.init_shard_params``) and holds its shard of the
cache (its rows of the batch over ``"data"``, its KV heads, SSM heads and
their conv channels over ``"model"``); the row-parallel products,
Mamba-2's gated norm, the embedding and the logits cross the model group
through the world's transport (``--rank-transport``: ``device``, copies
between the ranks' device mailboxes, the default on ``cuda``; ``gloo``
through host memory, the default on the CPU). Rank 0 prints. Every family
serves on ranks: dense, vlm, moe (grok-1-314b's experts, 2 a rank on 4
ranks; deepseek-v3-671b's, 64 a rank, with MLA's heads split and its
latent cache whole on every rank), ssm (mamba2-1.3b, 16 of its 64 heads a
rank on 4), hybrid (zamba2-1.2b: its Mamba-2 heads and the shared block's
heads and ring) and encdec (seamless-m4t-large-v2 on 2 or 4 ranks, its
cross cache the launcher's zeros, a rank's KV heads of them). Where the
axis does not divide the vocabulary (seamless-m4t-large-v2's 256 206 on 4
ranks) the embedding and the head split d_model instead. An arch whose
heads or widths the model axis does not divide exits naming what does not
divide, before any rank starts. ``--layers N`` keeps the config's first N
layers at full width (a moe arch's leading dense layers first), so that a
moe arch fits the card without ``--reduced``: ``--arch grok-1-314b
--layers 8 --host-devices 4 --ranks`` holds 14 GB of bf16 weights a rank.
"""

import argparse
import dataclasses
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers (full width)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="serve under a logical mesh of N devices")
    ap.add_argument("--ranks", action="store_true",
                    help="with --host-devices N: one process per device of "
                         "the ('data', 'model') mesh, tensor-parallel over "
                         "'model' in a torch.distributed group")
    ap.add_argument("--rank-transport", default=None,
                    choices=("device", "gloo"),
                    help="with --ranks: how the rank processes exchange: "
                         "copies between device mailboxes (the default on "
                         "cuda) or gloo through host memory (the default "
                         "on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.ranks and args.host_devices < 1:
        sys.exit("--ranks lays the mesh of --host-devices N on N rank "
                 "processes; pass --host-devices N")

    import torch

    from repro_torch.configs.base import reduced as reduce_cfg
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_dev_mesh

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device (pass --device cpu to run on "
                         "the CPU)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.layers:
        if cfg.moe and args.layers <= cfg.moe.first_dense_layers:
            sys.exit(f"--layers {args.layers}: {cfg.name} keeps its "
                     f"{cfg.moe.first_dense_layers} dense layers first; "
                     "keep at least one MoE layer")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.ranks:
        from repro_torch.dist.ranks import spawn_ranks
        from repro_torch.dist.tensor_parallel import check_tp

        # the checks a rank would exit on, once, before any process starts
        try:
            check_tp(cfg, make_dev_mesh(args.host_devices,
                                        device="meta").shape["model"])
        except ValueError as exc:
            sys.exit(f"--ranks: {exc}")
        spawn_ranks(_rank_main, args.host_devices, args, cfg, device=device,
                    timeout=_RANK_TIMEOUT, transport=args.rank_transport)
        return
    mesh = (make_dev_mesh(args.host_devices, device=device)
            if args.host_devices else None)
    _serve(args, cfg, device, mesh)


# a ranked run's deadline, and its collectives'
_RANK_TIMEOUT = 24 * 3600.0


def _rank_main(rank, world, args, cfg, *, device):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_dev_mesh

    _serve(args, cfg, device, make_dev_mesh(world, device=device,
                                            group=dist.group.WORLD))


def _serve(args, cfg, device, mesh) -> None:
    """The warm-up and the timed greedy steps, on one process or on this
    rank of a mesh of ranks; prints (rank 0 only, on ranks)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.ctx import launch_mesh
    from repro_torch.dist.sharding import kv_head_pad
    from repro_torch.dist.tensor_parallel import (init_shard_cache,
                                                  init_shard_params)
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.decode import make_serve_step

    device = torch.device(device)
    ranked = mesh is not None and mesh.group is not None
    show = not ranked or dist.get_rank() == 0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    pad = kv_head_pad(cfg, mesh.shape["model"]) if mesh else 1
    if show:
        print(f"device: {where}, arch={cfg.name}" + (
            f", mesh: {mesh.shape} " + (f"on {mesh.size} rank processes"
                                        if ranked else "(logical)")
            + f", kv_head_pad {pad}" if mesh else ""), flush=True)

    def drain():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if ranked:
            dist.barrier()

    with torch.inference_mode(), launch_mesh(mesh,
                                             global_batch=args.batch):
        if ranked:
            params = init_shard_params(cfg, mesh, seed=args.seed,
                                       device=device)
            cache = init_shard_cache(cfg, mesh, args.batch, args.max_seq,
                                     device=device)
        else:
            params = tfm.init_params(cfg, seed=args.seed, device=device)
            enc_out = None
            if cfg.family == "encdec":
                enc_out = tuple(torch.zeros(
                    (cfg.n_layers, args.batch, cfg.n_kv_heads, args.max_seq,
                     cfg.head_dim), dtype=torch.bfloat16, device=device)
                    for _ in range(2))
            cache = tfm.init_cache(cfg, args.batch, args.max_seq,
                                   enc_out=enc_out, device=device,
                                   kv_head_pad=pad)
        # this rank's rows of the batch: dim 1 of a segment's first leaf
        rows = (next(iter(cache.layers.values()))[0].shape[1] if ranked
                else args.batch)
        step = make_serve_step(cfg)
        tok = torch.ones((rows,), dtype=torch.int64, device=device)
        tok, _, cache = step(params, tok, cache)          # warm-up
        out = []
        drain()
        t0 = time.perf_counter()
        for _ in range(args.tokens):
            tok, _, cache = step(params, tok, cache)
            out.append(tok)
        sample = torch.stack(out, 1)[0][:12].tolist()    # waits for the device
        drain()
        dt = time.perf_counter() - t0
    if show:
        print(f"decoded {args.tokens} x batch {args.batch}: "
              f"{args.batch * args.tokens / dt:.1f} tok/s; sample {sample}",
              flush=True)


if __name__ == "__main__":
    main()
