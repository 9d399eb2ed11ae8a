"""Training launcher: seeded state on one device, the step loop, async
checkpointing and the elastic control loop.

    python -m repro_torch.launch.train --arch starcoder2-3b --steps 100 \
        [--reduced] [--microbatch 4] [--ckpt-dir ckpt] [--device cpu] \
        [--pipeline STAGES] [--host-devices N] [--multi-pod] [--ranks] \
        [--elastic --fake-hosts H [--kill-host H@S] [--lease L]]

The JAX package's launcher (``repro.launch.train``) on one device: its
flags, its data (``SyntheticLM``, learnable when ``--reduced``, or
``--data`` tokens), its checkpoint cadence and its printed lines (``step
… loss … |g| … tok/s``, ``elastic restore from step …``, ``done``). Runs
on ``cuda`` unless ``--device cpu``. A checkpoint at step n holds the
state after step n's update, so a run resumes at step n + 1: the
reference resumes at n and applies step n's batch twice.

``--elastic`` runs the heartbeat/straggler/re-mesh decision loop
(``train/elastic.py``) over ``--fake-hosts`` hosts that share the devices
(chips_per_host = N / hosts, the model axis min(4, chips_per_host));
``--kill-host H@S`` stops host H's heartbeats at step S, and a host silent
for ``--lease`` steps is declared failed. On the controller's plan the
launcher prints ``host failure: survivors …``, quiesces the saver,
restores the latest checkpoint onto the survivors' (data, model) mesh,
the model axis kept and the data axis shrunk, and finishes the same
absolute number of steps. ``--transport`` first runs a preflight of
active messages between the hosts over ``core/comm``.

Meshes are logical (``launch/mesh.py``): named axes over the one device,
picked as the reference's ``_run_epoch`` picks them. ``--pipeline STAGES``
trains stage-parallel (``make_pipeline_train_step``, dense family only) on
a ("pipe", "data", "model") mesh of (STAGES, N / STAGES, 1) with
``--microbatch`` microbatches if > 1, else 2·STAGES (the GPipe rule).
``--host-devices N`` stands for N devices: a ("data", "model") mesh of
(N / model, model), model = min(4, N) (the elastic controller's model axis
under ``--elastic``; after a host failure the survivors' re-mesh shape),
the production (16, 16) mesh from N = 256 on, and with ``--multi-pod``
the (2, 16, 16) one from N = 512 on (``--multi-pod`` alone stands for 512).
Under a mesh the batch axes and sequence sharding are set as the reference
sets them, and the MoE dispatches ``data_rows()`` rows. With none of these
flags the run has no mesh.

``--ranks`` runs the mesh's axes as rank processes, as the reference
runs them as devices (``dist.ranks.spawn_ranks``: they share the card on
``cuda``, or the CPU, and exchange through ``--rank-transport``:
``device``, copies between their device mailboxes, the default on
``cuda``; ``gloo`` through host memory, the default on the CPU; not
``--transport``, the host runtime's preflight). With ``--host-devices
N`` it starts N processes on the launcher's ("data", "model") mesh,
``make_dev_mesh(N, group=)``: (N / model, model), model = min(4, N) (the
elastic controller's under ``--elastic``). Each rank draws, trains and
checkpoints only its tensor-parallel shard of the parameters and of the
optimizer's state, AdamW's or Adafactor's
(``tensor_parallel.init_shard_params``, ``make_train_step(cfg, mesh=)``,
``checkpoint.RankCheckpointer`` with each leaf's box): every family.
With ``--pipeline S --host-devices N`` (N defaults to S) it starts N
processes on the (S, N / S, 1) pipelined mesh, each holding, training and
checkpointing its own stage's leaves (``make_pipeline_train_step`` on a
``Mesh(..., group=)``). Either way the checkpoint is the reference's
layout, byte for byte, and restores onto any mesh; rank 0 prints the
step lines. Before any world starts the launcher exits naming what the
mesh does not divide.

With ``--ranks --elastic`` the launcher holds the one controller for the
run and starts a world of rank processes a mesh lifetime: rank r is chip
r mod chips_per_host of the world's r // chips_per_host-th surviving
host. Every rank steps a copy of the controller on the beats of one
all-gather a step (``_heartbeat``), so that all leave the step loop at
the same step with the same plan; the world hands the controller back,
and the next world of the survivors' ranks restores the latest
checkpoint and resumes. A rank process that a signal kills ends its
world at once (``spawn_ranks`` raises ``RankDied``): the launcher
declares its host failed (``ElasticController.declare_failed``) and
re-meshes through the same plan. A rank that raises or exits fails the
run. A re-mesh whose data axis does not divide the batch, or whose
survivors cannot hold the model axis, exits before the next world.
``--elastic`` with ``--pipeline`` exits as the reference does.
"""

import argparse
import os
import signal
import sys
import time
from typing import NamedTuple, Optional


class _Elastic(NamedTuple):
    """The elastic loop's part of a step loop: the controller (a rank's
    copy, on ranks), ``--kill-host``'s (host, step) or (None, None), and on
    ranks the world's hosts in rank order (rank r is chip r mod
    chips_per_host of ``hosts[r // chips_per_host]``; None on one
    process)."""
    controller: object
    kill: tuple
    hosts: Optional[list] = None


def main(argv=None, *, cfg=None, fault=None):
    """Parse ``argv`` and train; ``cfg`` (a ``ModelConfig``) stands for
    ``--arch``'s config, which ``--reduced`` then does not cut. On ranks it
    returns each world's ranks' records (``_step_loop``), with ``fault``
    (tests only) a rank of the first world that dies by SIGKILL or exits:
    ``{"rank": r, "step": s, "at": "step", "save" or "exit"}``, by SIGKILL
    after step s or inside step s's checkpoint write (its parts written,
    before the publish), or by ``sys.exit`` after step s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--pipeline", type=int, default=0, metavar="STAGES",
                    help="stage-parallel training on a ('pipe', 'data', "
                         "'model') mesh: the layer stack splits into STAGES "
                         "pipeline stages (repro_torch.dist.pipeline). "
                         "Microbatch count = --microbatch if > 1 else "
                         "2*STAGES (GPipe rule).")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the logical (2, 16, 16) multi-pod mesh")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="a logical mesh of N devices on the one device")
    ap.add_argument("--data", default=None)
    ap.add_argument("--ckpt-dir", default="ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--elastic", action="store_true",
                    help="run the heartbeat/straggler/re-mesh decision loop "
                         "around the step loop: on a declared host failure "
                         "the survivors restore the latest checkpoint (with "
                         "--ranks: on a new world of their rank processes)")
    ap.add_argument("--fake-hosts", type=int, default=0,
                    help="with --elastic: pretend the devices (with "
                         "--ranks: the rank processes) are shared by N "
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
    ap.add_argument("--ranks", action="store_true",
                    help="with --host-devices N or --pipeline: one process "
                         "per device of the mesh, joined in a "
                         "torch.distributed group")
    ap.add_argument("--rank-transport", default=None,
                    choices=("device", "gloo"),
                    help="with --ranks: how the rank processes exchange: "
                         "copies between device mailboxes (the default on "
                         "cuda) or gloo through host memory (the default "
                         "on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.ranks and args.pipeline < 1 and args.host_devices < 1:
        sys.exit("--ranks lays the ('data', 'model') mesh of --host-devices "
                 "N on N rank processes (tensor-parallel training, ROADMAP "
                 "A8d6), or the pipelined one of --pipeline STAGES; pass "
                 "--host-devices N")

    import torch

    from repro_torch.configs.base import reduced as reduce_cfg
    from repro_torch.configs.registry import get_config
    from repro_torch.train.elastic import ElasticController

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("train: no CUDA device (pass --device cpu to run on the "
                 "CPU)")
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduce_cfg(cfg)
    seq = args.seq or (128 if args.reduced else 4096)
    global_batch = args.global_batch or (8 if args.reduced else 256)
    # logical devices of the mesh (0: no mesh)
    n_dev = args.host_devices or (512 if args.multi_pod else 0) \
        or args.pipeline

    elastic = None
    if args.elastic:
        if args.pipeline > 1:
            sys.exit("--elastic does not compose with --pipeline yet")
        fake_hosts = args.fake_hosts or 1
        if n_dev % fake_hosts:
            sys.exit(f"--fake-hosts {fake_hosts} does not divide {n_dev} "
                     "devices")
        chips = n_dev // fake_hosts if n_dev else 1
        controller = ElasticController(n_hosts=fake_hosts,
                                       chips_per_host=chips,
                                       model_axis=max(1, min(4, chips)),
                                       dead_after=args.lease)
        kill = (None, None)
        if args.kill_host:
            kh, ka = args.kill_host.split("@")
            kill = (int(kh), int(ka))
        if args.transport:
            _transport_preflight(args.transport, fake_hosts)
        elastic = _Elastic(controller, kill,
                           controller.alive() if args.ranks else None)

    if args.ranks:
        return _train_ranks(args, cfg, seq, global_batch, n_dev, device,
                            elastic, fault)

    shape_override = None  # set by a re-mesh plan after a host failure
    end = None  # absolute final step, fixed across restores
    while True:
        mesh = _pick_mesh(args, cfg, n_dev, shape_override,
                          elastic and elastic.controller, device)
        run = _run_epoch(args, cfg, seq, global_batch, device, mesh,
                         elastic, end)
        if run["error"]:
            sys.exit(run["error"])
        plan, end = run["plan"], run["end"]
        if plan is None:
            return None
        if n_dev:
            n_dev = len(plan.survivors) * elastic.controller.chips_per_host
            shape_override = plan.mesh_shape


# a ranked run's deadline, and its collectives' (a dead rank is caught at
# once by ``spawn_ranks``; a hung one by this)
_RANK_TIMEOUT = 24 * 3600.0


def _train_ranks(args, cfg, seq, global_batch, n_dev, device, elastic,
                 fault):
    """``--ranks``: one world of rank processes, or under ``--elastic`` one
    world a mesh lifetime. The controller lives here for the whole run: a
    world's ranks step copies of it (``_heartbeat``) and hand it back with
    the plan that ended the world; a rank that dies ends its world at once
    (``spawn_ranks`` raises ``RankDied``), and its host is declared failed
    here (``_declare``). Each world's mesh is checked before it starts.
    Returns per world its wall clock at ``t_spawn`` and ``t_end``, the
    ranks that ``died``, the ``plan`` that ended it and its ranks' records
    (``_step_loop``; None where a rank died)."""
    from repro_torch.dist.ranks import RankDied, spawn_ranks
    from repro_torch.train import checkpoint as ckpt

    end = None
    if elastic is not None:     # every world ends at the same step
        latest = ckpt.latest_step(args.ckpt_dir)
        end = (0 if latest is None else latest + 1) + args.steps
    worlds = []
    while True:
        # the checks a rank would exit on, once, before any process starts
        mesh = _pick_mesh(args, cfg, n_dev, None,
                          elastic and elastic.controller, device)
        if args.pipeline > 1:
            _n_micro(args, mesh, global_batch)
        else:
            _check_ranked(args, cfg, mesh, global_batch)
        t0 = time.time()
        try:
            runs = spawn_ranks(_rank_main, n_dev, args, cfg, seq,
                               global_batch, elastic, end,
                               None if worlds else fault, device=device,
                               timeout=_RANK_TIMEOUT,
                               transport=args.rank_transport)
        except RankDied as exc:
            if elastic is None:
                raise
            worlds.append({"t_spawn": t0, "t_end": time.time(),
                           "died": exc.ranks, "ranks": None})
            plan = worlds[-1]["plan"] = _declare(
                elastic, exc.ranks, ckpt.latest_step(args.ckpt_dir))
        else:
            plan = runs[0]["plan"]
            worlds.append({"t_spawn": t0, "t_end": time.time(), "died": [],
                           "plan": plan, "ranks": runs})
            if runs[0]["error"]:
                sys.exit(runs[0]["error"])
            if plan is None:
                return worlds
            elastic = elastic._replace(controller=runs[0]["controller"])
        n_dev = len(plan.survivors) * elastic.controller.chips_per_host
        elastic = elastic._replace(hosts=plan.survivors)


def _declare(elastic, died, latest):
    """A world's ranks ``died``: declare their hosts failed
    (``declare_failed``) and poll the controller at its latest beat, so
    that only they are newly dead; returns the plan (exits where the
    survivors cannot hold the model axis)."""
    c = elastic.controller
    now = max(c.monitor.last_seen.values(), default=0.0)
    for r in died:
        h = elastic.hosts[r // c.chips_per_host]
        print(f"rank {r} (host {h}) died: declared failed", flush=True)
        c.declare_failed(h)
    try:
        plan = c.poll(latest, now=now)
    except RuntimeError as exc:
        sys.exit(str(exc))
    print(f"host failure: survivors {plan.survivors}, re-mesh "
          f"{plan.mesh_shape}, restore step {plan.restore_step}",
          flush=True)
    return plan


def _rank_main(rank, world, args, cfg, seq, global_batch, elastic=None,
               end=None, fault=None, *, device):
    """One rank of a ``--ranks`` run: the step loop on its own place of the
    mesh; returns its record (``_step_loop``), with its transport's name,
    the bytes it staged through the host and its mailbox's size."""
    import torch
    import torch.distributed as dist

    t_start = time.time()
    device = torch.device(device)
    mesh = _pick_mesh(args, cfg, world, None,
                      elastic and elastic.controller, device,
                      group=dist.group.WORLD)
    run = _run_epoch(args, cfg, seq, global_batch, device, mesh, elastic,
                     end, fault)
    net = mesh.transport
    return {**run, "t_start": t_start, "transport": net.name,
            "staged_bytes": net.staged_bytes,
            "mailbox_bytes": getattr(net, "mailbox_bytes", 0)}


def _pick_mesh(args, cfg, n_dev, shape_override, controller, device,
               group=None):
    """The run's logical mesh, as the reference's ``_run_epoch`` picks it;
    None without a mesh flag."""
    from repro_torch.launch.mesh import (Mesh, make_dev_mesh,
                                         make_pipeline_mesh,
                                         make_production_mesh)
    from repro_torch.models.transformer import layer_kinds

    if not n_dev:
        return None
    if args.ranks and args.pipeline <= 1:
        try:      # (n / model, model): the controller's model axis, if any
            return make_dev_mesh(n_dev, controller.model_axis if controller
                                 else max(1, min(4, n_dev)), device,
                                 group=group)
        except ValueError as exc:
            sys.exit(str(exc))
    if shape_override is not None:
        return Mesh(shape_override, ("data", "model"), device)
    if args.pipeline > 1:
        if set(layer_kinds(cfg)) != {"dense"}:
            sys.exit(f"--pipeline supports the dense family for now; "
                     f"{cfg.name} is {cfg.family!r}")
        if n_dev % args.pipeline:
            sys.exit(f"--pipeline {args.pipeline} does not divide "
                     f"{n_dev} devices")
        if cfg.n_layers % args.pipeline:
            sys.exit(f"{cfg.n_layers} layers do not split into "
                     f"{args.pipeline} equal pipeline stages")
        return make_pipeline_mesh(args.pipeline, n_dev, device, group=group)
    if n_dev >= 512 and args.multi_pod:
        return make_production_mesh(multi_pod=True, device=device)
    if n_dev >= 256:
        return make_production_mesh(device=device)
    return make_dev_mesh(n_dev, controller.model_axis if controller else 0,
                         device)


def _n_micro(args, mesh, global_batch: int) -> int:
    """The pipelined step's microbatch count: ``--microbatch`` if > 1,
    else 2·STAGES (the GPipe rule); exits unless it splits each data
    rank's rows of the batch (all of it on a logical mesh)."""
    n_micro = args.microbatch if args.microbatch > 1 else 2 * args.pipeline
    if global_batch % ((mesh.shape["data"] if args.ranks else 1) * n_micro):
        sys.exit(f"batch {global_batch} does not split into {n_micro} "
                 "microbatches" + (f" on each of {mesh.shape['data']} data "
                                   "ranks" if args.ranks else ""))
    return n_micro


def _check_ranked(args, cfg, mesh, global_batch: int) -> None:
    """Exit unless the ranks of ``mesh`` train ``cfg`` without the pipeline
    (``check_ranked_training``) and each microbatch of the global batch
    splits over the data axis."""
    from repro_torch.train.train_step import check_ranked_training

    try:
        check_ranked_training(cfg, mesh.shape["model"])
    except ValueError as exc:
        sys.exit(str(exc))
    rows = mesh.shape["data"] * max(args.microbatch, 1)
    if global_batch % rows:
        sys.exit(f"batch {global_batch} does not split into "
                 f"{max(args.microbatch, 1)} microbatches over "
                 f"{mesh.shape['data']} data ranks")


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


def _run_epoch(args, cfg, seq, global_batch, device, mesh, elastic, end,
               fault=None):
    """One run of the step loop (under ``mesh``, when there is one); its
    record (``_step_loop``)."""
    from repro_torch.dist.ctx import launch_mesh

    with launch_mesh(mesh, global_batch=global_batch, seq_len=seq):
        return _step_loop(args, cfg, seq, global_batch, device, mesh,
                          elastic, end, fault)


def _step_loop(args, cfg, seq, global_batch, device, mesh, elastic, end,
               fault):
    """The step loop from the latest checkpoint (or the seed) to ``end``
    (from ``--steps`` where None). Returns its record: ``plan``, None on
    normal completion, else the ElasticPlan that ended the run (the
    caller runs again, restoring the latest checkpoint); ``error``, the
    controller's where the survivors cannot hold the model axis; ``end``;
    ``controller``; and per step its ``loss``, ``grad_norm``, ``ms`` and
    wall clock at its end (``steps``), the checkpoints' ``save_s``, the
    ``restore_s``, the plan's wall clock ``t_plan`` and the kernels'
    ``launches`` in the loop."""
    import torch

    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.dist.ranks import launch_counts
    from repro_torch.models.transformer import abstract_params, init_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import PackedBinaryDataset, SyntheticLM
    from repro_torch.train.elastic import StragglerDetector
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_pipeline_train_step,
                                              make_train_step,
                                              pipeline_rows, pipeline_shard)

    ranked = mesh is not None and mesh.group is not None
    tensor = ranked and args.pipeline <= 1     # the model axis on ranks
    rank = torch.distributed.get_rank() if ranked else 0
    controller = elastic and elastic.controller
    record = {"plan": None, "error": None, "controller": controller,
              "steps": {}, "save_s": {}, "restore_s": None, "t_plan": None}

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    layout = ("one device" if mesh is None else
              f"{mesh.shape} on {mesh.size} rank processes" if ranked else
              f"{mesh.shape} (logical) on one device")
    say(f"mesh: {layout} ({where}), arch={cfg.name} "
        f"({cfg.n_params() / 1e9:.2f}B params), seq={seq} "
        f"batch={global_batch}")

    init_opt, _ = make_optimizer(cfg.optimizer)
    like = abstract_params(cfg)
    like = {"params": like, "opt": init_opt(like)}
    # a rank holds, trains and checkpoints only its own shard (the model
    # axis) or its own stage's leaves (the pipe axis)
    own, rows = like, None
    if tensor:
        own, rows = tp.shard_tree(cfg, like, mesh), tp.shard_boxes(
            cfg, like, mesh)
    elif ranked:
        own = pipeline_shard(cfg, like, mesh)
        rows = pipeline_rows(cfg, own, mesh)
    start = 0
    latest = ckpt.latest_step(args.ckpt_dir)
    if latest is None and tensor:
        params = tp.init_shard_params(cfg, mesh, seed=args.seed,
                                      device=device)
        opt_state = init_opt(params)
    elif latest is None and ranked:
        params = pipeline_shard(cfg, init_params(cfg, seed=args.seed,
                                                 device=device), mesh)
        opt_state = init_opt(params)
    elif latest is None:
        params, opt_state = init_train_state(cfg, seed=args.seed,
                                             device=device)
    else:
        say(f"elastic restore from step {latest} (resuming at step "
            f"{latest + 1})")
        t0 = time.perf_counter()
        state = ckpt.restore(args.ckpt_dir, latest, own, device=device,
                             rows=rows)
        params, opt_state = state["params"], state["opt"]
        record["restore_s"] = time.perf_counter() - t0
        start = latest + 1

    if args.data:
        ds = PackedBinaryDataset(args.data, seq, global_batch)
    else:
        ds = SyntheticLM(cfg.vocab_size, seq, global_batch,
                         embed_dim=cfg.d_model if cfg.embed_inputs else None,
                         encdec=cfg.family == "encdec",
                         learnable=args.reduced)
    if args.pipeline > 1:
        step_fn = make_pipeline_train_step(
            cfg, mesh, lr=args.lr, n_micro=_n_micro(args, mesh, global_batch))
    else:
        step_fn = make_train_step(cfg, lr=args.lr,
                                  microbatches=args.microbatch,
                                  mesh=mesh if tensor else None)
    # a part several ranks hold is written by one of them: data rank 0,
    # and of a model line the first rank that holds the box
    writes = mesh.coords["data"] == 0 if ranked else True
    if tensor and writes:
        writes = tp.owned(cfg, like, mesh)
    saver = (ckpt.RankCheckpointer(args.ckpt_dir, keep=3, like=like,
                                   rows=rows, group=mesh.group,
                                   writes=writes)
             if ranked else ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3))
    monitor = StragglerDetector()
    if end is None:
        end = start + args.steps
    record["end"] = end

    def save(step):
        t0 = time.perf_counter()
        tree = {"params": params, "opt": opt_state}
        if _dies(fault, rank, step, "save"):    # its parts are written
            saver.written = lambda: os.kill(os.getpid(), signal.SIGKILL)
        saver.save(step, tree)
        record["save_s"][step] = time.perf_counter() - t0

    launched = launch_counts()
    for step in range(start, end):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in ds.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])     # waits for the step
        dt = time.perf_counter() - t0
        record["steps"][step] = {"loss": loss,
                                 "grad_norm": float(metrics["grad_norm"]),
                                 "ms": 1e3 * dt, "t": time.time()}
        monitor.record(0, dt)
        if step % 10 == 0 or step == end - 1:
            say(f"step {step:6d}  loss {loss:8.4f}  "
                f"|g| {float(metrics['grad_norm']):8.3f}  "
                f"{global_batch * seq / dt:10.0f} tok/s")
        if _dies(fault, rank, step, "step"):
            os.kill(os.getpid(), signal.SIGKILL)
        if _dies(fault, rank, step, "exit"):
            sys.exit(f"rank {rank} exits after step {step}")
        if step and step % args.ckpt_every == 0:
            save(step)
        if controller is not None:
            _heartbeat(elastic, mesh, step, dt)
            try:
                plan = controller.poll(ckpt.latest_step(args.ckpt_dir),
                                       now=float(step))
            except RuntimeError as exc:  # the survivors cannot hold the
                record["error"] = str(exc)   # model axis: on every rank
                break
            if plan is not None:
                record["t_plan"] = time.time()
                say(f"host failure: survivors {plan.survivors}, "
                    f"re-mesh {plan.mesh_shape}, restore step "
                    f"{plan.restore_step}")
                record["plan"] = plan
                break
    else:
        if not (end - 1 and (end - 1) % args.ckpt_every == 0):
            # (the loop saved a last step on the cadence: a second writer
            # of the same step would race the first on its directory)
            save(end - 1)
    saver.wait()  # quiesce (completion rule) before exit or the restore
    after = launch_counts()
    record["launches"] = {k: after[k] - launched[k] for k in after}
    if record["plan"] is None and record["error"] is None:
        say("done")
    return record


def _heartbeat(elastic, mesh, step: int, dt: float) -> None:
    """Step ``step``'s heartbeats into the controller (one controller step
    is one train step: ``now`` is the step index, the lease in steps):
    every alive host but ``--kill-host``'s from its step on. On ranks a
    host beats where each of its ranks does, and every rank learns every
    rank's beat and step time from one all-gather over the world
    (transport kind ``"beat"``), so that every rank's copy of the
    controller takes the same beats and polls to the same plan."""
    import torch
    import torch.distributed as dist

    c, (kill_host, kill_at) = elastic.controller, elastic.kill

    def silent(h):
        return h == kill_host and step >= kill_at

    if elastic.hosts is None:
        beats = {h: dt for h in c.alive() if not silent(h)}
    else:
        chips = c.chips_per_host
        me = elastic.hosts[dist.get_rank() // chips]
        mine = torch.tensor([0.0 if silent(me) else 1.0, dt],
                            device=mesh.device)
        got = torch.stack(mesh.transport.all_gather(
            mine, dist.group.WORLD, "beat")).cpu()
        beats = {h: float(got[i * chips:(i + 1) * chips, 1].max())
                 for i, h in enumerate(elastic.hosts)
                 if bool(got[i * chips:(i + 1) * chips, 0].all())}
    for h, t in beats.items():
        c.beat(h, t, now=float(step))


def _dies(fault, rank: int, step: int, at: str) -> bool:
    """Whether ``fault`` (``main``'s) kills this rank here."""
    return bool(fault) and (fault["rank"], fault["step"], fault["at"]) \
        == (rank, step, at)


if __name__ == "__main__":
    main()
