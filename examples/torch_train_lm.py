"""End-to-end training driver (PyTorch port): model + optimizer +
deterministic data + async checkpointing + restart, on any --arch from the
registry; ``--pipeline STAGES`` trains the dense family stage-parallel
(``repro_torch.dist.pipeline``) on a logical ("pipe", "data", "model")
mesh of the one device, and with ``--ranks N`` on N rank processes (a
(STAGES, N / STAGES, 1) mesh: one process per stage and data replica,
each holding and checkpointing its own stage's leaves). ``--ranks N``
without ``--pipeline`` trains the dense or vlm family tensor-parallel on
a (N / model, model) ("data", "model") mesh of N rank processes, model =
min(4, N) (``dist.tensor_parallel``: each rank holds, trains and
checkpoints its shard of the parameters and of the AdamW state).

The port's counterpart of ``examples/train_lm.py``. Defaults train a
reduced config on a *learnable* synthetic task (arithmetic progressions
mod vocab) so the loss demonstrably falls; pass --full for the published
config and --data for a packed uint32 token file. On ``cuda`` unless
``--device cpu``.

  PYTHONPATH=src python examples/torch_train_lm.py --arch qwen3-14b \
      --steps 60
  PYTHONPATH=src python examples/torch_train_lm.py --arch starcoder2-3b \
      --pipeline 2 --layers 4 --device cpu
  PYTHONPATH=src python examples/torch_train_lm.py --arch starcoder2-3b \
      --pipeline 2 --ranks 4 --layers 4 --device cpu
  PYTHONPATH=src python examples/torch_train_lm.py --arch starcoder2-3b \
      --ranks 4 --device cpu
"""

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.ranks import spawn_ranks
from repro_torch.launch.mesh import make_dev_mesh, make_pipeline_mesh
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import PackedBinaryDataset, SyntheticLM
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import (init_train_state,
                                          make_pipeline_train_step,
                                          make_train_step, pipeline_rows,
                                          pipeline_shard)
from repro_torch.models.transformer import abstract_params, init_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="published config (hardware scale)")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--d-ff", type=int, default=None)
    ap.add_argument("--pipeline", type=int, default=0, metavar="STAGES")
    ap.add_argument("--ranks", type=int, default=0, metavar="N",
                    help="N rank processes: the pipelined mesh with "
                         "--pipeline, else a ('data', 'model') mesh")
    ap.add_argument("--data", default=None, help="packed uint32 token file")
    ap.add_argument("--ckpt-dir", default="ckpt/train_lm")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_lm: no CUDA device (pass --device cpu to run "
                         "on the CPU)")

    cfg = get_config(args.arch)
    if not args.full:
        overrides = {}
        if args.d_model:
            overrides.update(d_model=args.d_model, d_head=args.d_model // 8,
                             n_heads=8, n_kv_heads=4)
        if args.layers:
            overrides["n_layers"] = args.layers
        if args.vocab:
            overrides["vocab_size"] = args.vocab
        if args.d_ff:
            overrides["d_ff"] = args.d_ff
        cfg = reduced(cfg, **overrides)
    print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
          f"(active {cfg.n_active_params() / 1e6:.1f}M) opt={cfg.optimizer} "
          f"on {device}")
    if args.ranks:
        if args.pipeline and args.ranks % args.pipeline:
            raise SystemExit("--ranks N needs --pipeline STAGES dividing N")
        spawn_ranks(train, args.ranks, args, cfg, device=device,
                    timeout=24 * 3600.0)
    else:
        train(0, 1, args, cfg, device=device, ranks=False)


def train(rank, world, args, cfg, *, device, ranks=True):
    """The training loop, on one device or as rank ``rank`` of ``world``
    rank processes."""
    device = torch.device(device)
    lead = rank == 0
    mesh = None
    tensor = ranks and args.pipeline < 1     # the model axis on ranks
    if tensor:
        mesh = make_dev_mesh(world, device=device, group=dist.group.WORLD)
    elif args.pipeline > 1 or ranks:
        mesh = make_pipeline_mesh(args.pipeline, world if ranks
                                  else args.pipeline, device,
                                  group=dist.group.WORLD if ranks else None)
    if args.data:
        ds = PackedBinaryDataset(args.data, args.seq, args.batch)
    else:
        ds = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                         embed_dim=cfg.d_model if cfg.embed_inputs else None,
                         encdec=cfg.family == "encdec", learnable=True)

    init_opt, _ = make_optimizer(cfg.optimizer)
    like = abstract_params(cfg)
    like = {"params": like, "opt": init_opt(like)}
    own, rows, writes = like, None, True
    if tensor:
        own, rows = tp.shard_tree(cfg, like, mesh), tp.shard_boxes(
            cfg, like, mesh)
        writes = tp.owned(cfg, like, mesh) if mesh.coords["data"] == 0 \
            else False
    elif ranks:
        own = pipeline_shard(cfg, like, mesh)
        rows = pipeline_rows(cfg, own, mesh)
        writes = mesh.coords["data"] == 0
    start = 0
    latest = ckpt.latest_step(args.ckpt_dir)
    if latest is None and tensor:
        params = tp.init_shard_params(cfg, mesh, seed=0, device=device)
        opt_state = init_opt(params)
    elif latest is None and ranks:
        params = pipeline_shard(cfg, init_params(cfg, seed=0, device=device),
                                mesh)
        opt_state = init_opt(params)
    elif latest is None:
        params, opt_state = init_train_state(cfg, seed=0, device=device)
    else:
        if lead:
            print(f"resuming from checkpoint step {latest}")
        state = ckpt.restore(args.ckpt_dir, latest, own, device=device,
                             rows=rows)
        params, opt_state = state["params"], state["opt"]
        start = latest + 1

    if tensor:
        step_fn = make_train_step(cfg, lr=args.lr, mesh=mesh)
        if lead:
            print(f"tensor parallel: mesh {mesh.shape} on {world} rank "
                  "processes")
    elif mesh is not None:
        step_fn = make_pipeline_train_step(cfg, mesh, lr=args.lr,
                                           n_micro=2 * args.pipeline)
        if lead:
            print(f"pipeline: {args.pipeline} stages x {2 * args.pipeline} "
                  f"microbatches, mesh {mesh.shape}"
                  + (f" on {world} rank processes" if ranks else ""))
    else:
        step_fn = make_train_step(cfg, lr=args.lr)
    saver = (ckpt.RankCheckpointer(args.ckpt_dir, keep=2, like=like,
                                   rows=rows, group=mesh.group,
                                   writes=writes)
             if ranks else ckpt.AsyncCheckpointer(args.ckpt_dir, keep=2))

    t0 = time.perf_counter()
    for step in range(start, start + args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in ds.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if lead and (step % 5 == 0 or step == start + args.steps - 1):
            loss = float(metrics["loss"])         # waits for the step
            gn = float(metrics["grad_norm"])
            tok_s = (step - start + 1) * args.batch * args.seq \
                / (time.perf_counter() - t0)
            print(f"step {step:5d}  loss {loss:7.4f}  |g| {gn:8.3f}  "
                  f"{tok_s:9.0f} tok/s", flush=True)
        if step and step % args.ckpt_every == 0:
            saver.save(step, {"params": params, "opt": opt_state})
    saver.wait()  # quiesce in-flight writes before exit (completion rule)
    if lead:
        print("done; checkpoints in", args.ckpt_dir)


if __name__ == "__main__":
    main()
