"""Training launcher: seeded state on one device, the step loop, async
checkpointing and the elastic control loop.

    python -m repro_torch.launch.train --arch starcoder2-3b --steps 100 \
        [--reduced] [--microbatch 4] [--ckpt-dir ckpt] [--device cpu]

The JAX package's launcher (``repro.launch.train``) on one device: its
flags, its data (``SyntheticLM``, learnable when ``--reduced``, or
``--data`` tokens), its checkpoint cadence and its printed lines (``step
… loss … |g| … tok/s``, ``elastic restore from step …``, ``done``). Runs
on ``cuda`` unless ``--device cpu``. A checkpoint at step n holds the
state after step n's update, so a run resumes at step n + 1: the
reference resumes at n and applies step n's batch twice.

``--elastic`` runs the heartbeat/straggler/re-mesh decision loop
(``train/elastic.py``) over ``--fake-hosts`` logical hosts of the one
device; ``--kill-host H@S`` stops host H's heartbeats at step S. On the
controller's plan the launcher prints ``host failure: survivors …``,
quiesces the saver, restores the latest checkpoint onto the same device
and finishes the steps. ``--transport`` first runs a preflight of active
messages between the hosts over ``core/comm``. ``--pipeline`` waits for
the port's pipeline (ROADMAP A9), ``--multi-pod`` and ``--host-devices``
for its meshes (A13).
"""

import argparse
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--pipeline", type=int, default=0, metavar="STAGES",
                    help="stage-parallel training: not ported yet (A9)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the production multi-pod mesh: not ported (A13)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="forced host devices of the JAX package: not "
                         "ported (A13)")
    ap.add_argument("--data", default=None)
    ap.add_argument("--ckpt-dir", default="ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--elastic", action="store_true",
                    help="run the heartbeat/straggler/re-mesh decision loop "
                         "around the step loop: on a declared host failure "
                         "the survivors restore the latest checkpoint")
    ap.add_argument("--fake-hosts", type=int, default=0,
                    help="with --elastic: pretend the device is shared by N "
                         "hosts")
    ap.add_argument("--kill-host", default=None, metavar="HOST@STEP",
                    help="fault injection: fake host HOST stops "
                         "heartbeating at STEP")
    ap.add_argument("--lease", type=float, default=2.0,
                    help="steps without a heartbeat before a host is "
                         "declared dead (--elastic)")
    ap.add_argument("--transport", default=None,
                    choices=("inproc", "multiproc"),
                    help="with --elastic: comm backend of the cross-host "
                         "control-plane preflight")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.pipeline:
        sys.exit("--pipeline: the pipeline is not ported yet (ROADMAP A9)")
    if args.multi_pod or args.host_devices:
        sys.exit("--multi-pod / --host-devices: meshes are not ported yet "
                 "(ROADMAP A13)")

    import torch

    from repro_torch.configs.base import reduced as reduce_cfg
    from repro_torch.configs.registry import get_config
    from repro_torch.train.elastic import ElasticController

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("train: no CUDA device (pass --device cpu to run on the "
                 "CPU)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    seq = args.seq or (128 if args.reduced else 4096)
    global_batch = args.global_batch or (8 if args.reduced else 256)

    controller = None
    kill_host = kill_at = None
    if args.elastic:
        fake_hosts = args.fake_hosts or 1
        controller = ElasticController(n_hosts=fake_hosts, chips_per_host=1,
                                       model_axis=1, dead_after=args.lease)
        if args.kill_host:
            kh, ka = args.kill_host.split("@")
            kill_host, kill_at = int(kh), int(ka)
        if args.transport:
            _transport_preflight(args.transport, fake_hosts)

    end = None  # absolute final step, fixed across restores
    while True:
        plan, end = _run_epoch(args, cfg, seq, global_batch, device,
                               controller, kill_host, kill_at, end)
        if plan is None:
            break


def _preflight_main(ctx):
    got = []
    am = ctx.comm.make_active_msg(lambda src: got.append(src))
    for d in range(ctx.n_ranks):
        if d != ctx.rank:
            am.send(d, ctx.rank)
    ctx.barrier_free_join()
    return len(got)


def _transport_preflight(transport: str, n_hosts: int) -> None:
    """Cross-host control-plane bootstrap over the comm backend
    (``repro_torch.core.comm``): every host sends an active message to
    every other and distributed completion drains the full set. Fails
    loudly before the step loop if any host pair cannot exchange
    messages."""
    from repro_torch.core import run_ranks

    t0 = time.time()
    counts = run_ranks(n_hosts, _preflight_main, transport=transport)
    dt = time.time() - t0
    if counts != [n_hosts - 1] * n_hosts:
        sys.exit(f"transport preflight failed: per-host AM counts {counts}")
    print(f"transport preflight [{transport}]: {n_hosts} hosts all-to-all "
          f"({n_hosts * (n_hosts - 1)} AMs) in {dt * 1e3:.1f}ms", flush=True)


def _run_epoch(args, cfg, seq, global_batch, device, controller, kill_host,
               kill_at, end):
    """One run of the step loop. Returns ``(plan, end)``: ``plan`` is None
    on normal completion, else the ElasticPlan that ended the run (the
    caller runs again, restoring the latest checkpoint)."""
    import torch

    from repro_torch.models.transformer import abstract_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import PackedBinaryDataset, SyntheticLM
    from repro_torch.train.elastic import StragglerDetector
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    print(f"mesh: one device ({where}), arch={cfg.name} "
          f"({cfg.n_params() / 1e9:.2f}B params), seq={seq} "
          f"batch={global_batch}", flush=True)

    start = 0
    latest = ckpt.latest_step(args.ckpt_dir)
    if latest is None:
        params, opt_state = init_train_state(cfg, seed=args.seed,
                                             device=device)
    else:
        print(f"elastic restore from step {latest} (resuming at step "
              f"{latest + 1})", flush=True)
        init_opt, _ = make_optimizer(cfg.optimizer)
        like = abstract_params(cfg)
        state = ckpt.restore(args.ckpt_dir, latest,
                             {"params": like, "opt": init_opt(like)},
                             device=device)
        params, opt_state = state["params"], state["opt"]
        start = latest + 1

    if args.data:
        ds = PackedBinaryDataset(args.data, seq, global_batch)
    else:
        ds = SyntheticLM(cfg.vocab_size, seq, global_batch,
                         embed_dim=cfg.d_model if cfg.embed_inputs else None,
                         encdec=cfg.family == "encdec",
                         learnable=args.reduced)
    step_fn = make_train_step(cfg, lr=args.lr, microbatches=args.microbatch)
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3)
    monitor = StragglerDetector()
    if end is None:
        end = start + args.steps

    for step in range(start, end):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in ds.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])     # waits for the step
        dt = time.perf_counter() - t0
        monitor.record(0, dt)
        if step % 10 == 0 or step == end - 1:
            print(f"step {step:6d}  loss {loss:8.4f}  "
                  f"|g| {float(metrics['grad_norm']):8.3f}  "
                  f"{global_batch * seq / dt:10.0f} tok/s", flush=True)
        if step and step % args.ckpt_every == 0:
            saver.save(step, {"params": params, "opt": opt_state})
        if controller is not None:
            # fake-host heartbeats: one controller step is one train step
            # (``now`` is the step index, the lease in steps)
            for h in controller.alive():
                if not (h == kill_host and step >= kill_at):
                    controller.beat(h, dt, now=float(step))
            plan = controller.poll(ckpt.latest_step(args.ckpt_dir),
                                   now=float(step))
            if plan is not None:
                print(f"host failure: survivors {plan.survivors}, "
                      f"re-mesh {plan.mesh_shape}, restore step "
                      f"{plan.restore_step}", flush=True)
                saver.wait()  # quiesce before the restore
                return plan, end
    saver.save(end - 1, {"params": params, "opt": opt_state})
    saver.wait()  # quiesce (completion rule) before exit
    print("done", flush=True)
    return None, end


if __name__ == "__main__":
    main()
