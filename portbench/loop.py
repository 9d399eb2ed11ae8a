"""One run of a cell: set-up, warm-up, the measured window and the check of
what the window produced, in this process or in each rank process of a
world (the mix's ``processes``).

A step is one whole run of the task graph through the application's
default executor, from a packed store on the device to the result's store,
drained. The window is a closed loop of steps over the mix's seeded inputs
in turn; it ends with the first step that ends ``seconds`` after the first
began. In a world a step starts after a barrier and ends after the stream
has drained and an all-reduce that doubles as the second barrier and tells
every rank whether the window is over; the slowest rank's time is the
world's.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from portbench import spec, trace as tracing
from portbench.yardstick import input_seed, least_s, sampler

# modules that no process of a run may hold once the window has closed,
# by top-level name: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def on(inp: dict, device) -> dict:
    """An input's tensors on ``device``."""
    return {k: v.to(device) for k, v in inp.items()}


class Body:
    """The matmul the program's GEMM-type bodies call: the port's
    ``task_matmul``, with its task slots counted (the batch dimension of
    each call) and, in a traced run, each call inside a ``trace.BODY``
    range."""

    def __init__(self, mm, mark: bool):
        self.mm, self.mark = mm, mark
        self.slots = self.calls = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        self.slots += a.shape[0]
        self.calls += 1
        if not self.mark:
            return self.mm(a, b)
        with torch.profiler.record_function(tracing.BODY):
            return self.mm(a, b)


def drive(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, *,
          device, group=None, plant: Optional[str] = None) -> dict:
    """This process's part of a run; returns its record (see the end)."""
    from repro_torch.kernels.block_gemm.ops import task_matmul

    torch.backends.cuda.matmul.allow_tf32 = False     # f32 is IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    app = spec.module("apps", cfg["app"])
    ref = spec.module("reference", cfg["app"])
    rank = None if group is None else dist.get_rank(group)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t = time.perf_counter()
    prog = app.build(cfg)
    build_s = time.perf_counter() - t
    b0, b1 = prog.spec.block_shape
    # each input is made on the device, packed, and kept on the host for
    # the check: the card holds the program's stores, not the harness's
    # dense copies
    inputs, stores = [], []
    for i in range(mix["inputs"]):
        inp = app.make_input(cfg, input_seed(seed, i), dev)
        stores.append(prog.pack(app.blocks(cfg, inp), device=dev)
                      if rank is None
                      else prog.pack_shard(app.blocks(cfg, inp), rank, dev))
        inputs.append(on(inp, "cpu"))
        del inp
    held = [(blk, rc) for blk, rc in app.result_blocks(cfg)
            if rank is None or prog.slot_of[blk][0] == rank]
    flat = torch.tensor([prog.slot_of[blk][1] if rank is not None else
                         prog.slot_of[blk][0] * prog.n_slots
                         + prog.slot_of[blk][1] for blk, _ in held],
                        dtype=torch.int64, device=dev)
    body = Body(task_matmul, mark=trace)
    ex = app.executor(prog, body, dev, group)
    step = ex
    if plant is not None:
        from portbench import faults

        step = faults.plant(plant, ex=ex, body=body, prog=prog, cfg=cfg,
                            app=app, ref=ref, inputs=inputs, stores=stores,
                            rank=rank)
    n_in = len(stores)
    for w in range(mix["warmup_steps"]):
        step(stores[w % n_in])
        sync()

    k = mix["checked_steps"]
    kept = torch.empty((k, len(held), b0, b1), dtype=prog.spec.dtype,
                       device=dev)
    kept_step: List[Optional[int]] = [None] * k
    pick = sampler(seed)
    body.slots = body.calls = 0
    if hasattr(ex, "reset"):
        ex.reset()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        window = torch.profiler.record_function(tracing.WINDOW)
        window.__enter__()
    steps: List[float] = []
    flag = torch.zeros(1, dtype=torch.int32)
    lo_ns = time.time_ns()
    i, done = 0, False
    while not done:
        if group is not None:
            dist.barrier(group)
        t0 = time.perf_counter()
        if i == 0:
            first, first_epoch = t0, time.time()
        out = step(stores[i % n_in])
        sync()
        over = time.perf_counter() - first >= seconds
        if group is not None:
            flag[0] = int(over)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
            over = bool(flag[0])
        t1 = time.perf_counter()
        steps.append(t1 - t0)
        done = over
        slot = i if i < k else int(pick.integers(0, i + 1))
        if slot < k:
            torch.index_select(out.view(-1, b0, b1), 0, flat, out=kept[slot])
            kept_step[slot] = i
        del out
        i += 1
    window_s = t1 - first
    sync()
    hi_ns = time.time_ns()
    summary = None
    if prof is not None:
        window.__exit__(None, None, None)
        prof.stop()
        summary = tracing.summarize(prof, lo_ns, hi_ns)
        del prof
    exchange_ms = ex.transport.ms if group is not None else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    modules = forbidden_modules()
    del ex, step, stores
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: the reference in float64 on each input a kept step used
    checked = []
    idx = torch.tensor([rc for _, rc in held], dtype=torch.int64, device=dev)
    for which in sorted({s % n_in for s in kept_step if s is not None}):
        want = app.reference(cfg, on(inputs[which], dev), ref,
                             dtype=torch.float64)
        nbr, nbc = want.shape[0] // b0, want.shape[1] // b1
        blocks = want.view(nbr, b0, nbc, b1).transpose(1, 2)
        want_blocks = blocks[idx[:, 0], idx[:, 1]]
        del want, blocks
        scale = want_blocks.abs().amax((1, 2))
        for slot, s in enumerate(kept_step):
            if s is not None and s % n_in == which:
                diff = (kept[slot].double() - want_blocks).abs().amax((1, 2))
                checked.append((s, which, float((diff / scale).max())))
        del want_blocks
    checked.sort()
    return {"rank": rank, "build_s": build_s, "first_epoch": first_epoch,
            "window_s": window_s, "steps": steps, "slots": body.slots,
            "calls": body.calls, "exchange_ms": exchange_ms, "peak": peak,
            "mailbox_bytes": mix.get("mailbox_bytes", 0) if group else 0,
            "device": name, "checked": checked, "modules": modules,
            "trace": summary}


def rank_main(rank: int, world: int, cfg: dict, mix: dict, seed: int,
              seconds: float, trace: bool, plant: Optional[str] = None, *,
              device) -> dict:
    """A rank process's part of a run (``dist.ranks.spawn_ranks`` calls
    it in each rank of the world)."""
    return drive(cfg, mix, seed, seconds, trace, device=device,
                 group=dist.group.WORLD, plant=plant)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             start_epoch: float, device="cuda", bench: Optional[dict] = None,
             mix_overrides: Optional[dict] = None,
             plant: Optional[str] = None) -> dict:
    """One run of ``cell_name``: the result line's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with a trace
    ``breakdown``), ``checked`` (each compared number with its limit) and
    ``forbidden`` (the JAX modules any process of the run held)."""
    bench = spec.benchmark() if bench is None else bench
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    mix = dict(spec.traffic(cell["traffic"]), **(mix_overrides or {}))
    if (mix["loop"], mix["clients"]) != ("closed", 1):
        raise ValueError(f"{cell['traffic']}: the harness drives a closed "
                         "loop of one client")
    world = mix["processes"]
    if world == 1:
        records = [drive(cfg, mix, seed, seconds, trace, device=device,
                         plant=plant)]
    else:
        records = _world(cfg, mix, seed, seconds, trace, device, plant)
    return _result(bench, cell, cfg, mix, records, trace, start_epoch)


def _world(cfg, mix, seed, seconds, trace, device, plant) -> List[dict]:
    import multiprocessing.forkserver as forkserver
    import multiprocessing.resource_tracker as resource_tracker

    from repro_torch.dist.ranks import spawn_ranks

    try:
        return spawn_ranks(rank_main, mix["processes"], cfg, mix, seed,
                           seconds, trace, plant, device=device,
                           transport=mix["transport"],
                           mailbox_bytes=mix["mailbox_bytes"],
                           timeout=mix["timeout_s"])
    finally:
        # the fork server and the resource tracker end with this call,
        # not some time after the run has printed
        forkserver._forkserver._stop()
        resource_tracker._resource_tracker._stop()


def _result(bench, cell, cfg, mix, records, trace, start_epoch) -> dict:
    app = spec.module("apps", cfg["app"])
    n = len(records[0]["steps"])
    if any(len(r["steps"]) != n for r in records):
        raise RuntimeError("ranks ran different numbers of steps")
    steps = np.max([r["steps"] for r in records], axis=0)
    limit = cfg["check"]["limit"]
    # each checked step's number: its worst block over every process
    errs = [float(np.max([r["checked"][j][2] for r in records]))
            for j in range(len(records[0]["checked"]))]
    failed = sum(not (e <= limit) for e in errs)
    cost = app.task_cost(cfg)
    world = {
        "cfg": cfg, "mix": mix, "n_steps": n,
        "window_s": max(r["window_s"] for r in records),
        "rank_window_s": [r["window_s"] for r in records],
        "steps_s": steps.tolist(),
        "setup_s": max(r["first_epoch"] for r in records) - start_epoch,
        "build_s": max(r["build_s"] for r in records),
        "slots": sum(r["slots"] for r in records),
        "real_tasks": sum(app.real_tasks(cfg).values()),
        "least_s": sum(c * least_s(*cost[t])
                       for t, c in app.real_tasks(cfg).items()),
        "flops": app.flops(cfg),
        "exchange_ms": [r["exchange_ms"] for r in records
                        if r["exchange_ms"] is not None],
        "device": (tracing.combine([r["trace"] for r in records])
                   if trace else None),
    }
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(bench, section, cell["name"]):
        value = spec.module("metrics", m["name"]).read(world)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": records[0]["device"],
              "count": cell["chips"],
              "memory_peak_bytes": sum(r["peak"] + r["mailbox_bytes"]
                                       for r in records)}
    out = {"correct": bool(errs) and failed == 0, "attempted": n,
           "failed": failed, "metrics": metrics, "device": device}
    if trace:
        dv = world["device"]
        device["busy_s"] = dv["busy_s"]
        device["window_s"] = dv["window_s"]
        out["breakdown"] = dv["breakdown"]
    name = cfg["check"]["name"]
    worst = (max(errs) if errs and all(math.isfinite(e) for e in errs)
             else None)          # None: nothing checked, or not a number
    out["checked"] = {name: {"value": worst, "limit": limit},
                      "steps_checked": len(errs)}
    out["notes"] = _notes(world, records)
    out["forbidden"] = sorted({m for r in records for m in r["modules"]}
                              | set(forbidden_modules()))
    return out


def _notes(world: dict, records: List[dict]) -> List[str]:
    """Lines for standard error that show how the run's numbers were read
    (not part of the result line)."""
    lines = [f"steps {world['n_steps']} in {world['window_s']:.6f} s; "
             f"body slots {world['slots']} for "
             f"{world['real_tasks'] * world['n_steps']} real tasks"]
    for r in records:
        lines.append(f"process {r['rank']}: build {r['build_s']:.4f} s, "
                     f"body calls {r['calls']}, slots {r['slots']}, "
                     f"exchange ms {r['exchange_ms']}, peak {r['peak']}")
    dv = world["device"]
    if dv is not None:
        lines.append(f"trace: busy {dv['busy_s']:.6f} s of "
                     f"{dv['window_s']:.6f}; body {dv['body_s']:.6f} s in "
                     f"{dv['body_ops']} device ops under "
                     f"{dv['body_ranges']} body ranges; device events kept "
                     f"{dv['kept']} of {dv['seen']}")
    return lines
