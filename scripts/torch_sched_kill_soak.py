"""Soak the resident scheduler's kill recovery: how often a rank that is
alive gets declared dead.

    PYTHONPATH=src python scripts/torch_sched_kill_soak.py \
        [--runs 20] [--phase N] [--device cuda] [--block 512]

Runs ``chip_smoke.py``'s sched-chained-10-kill stream ``--runs`` times: 10
stencil 16 x 12 submissions (b 512 f32 blocks) chained through one
namespace on 4 resident ``inproc`` ranks x 2 worker threads, rank 1
killed at its 30th AM (``FaultPlan(seed=11, kill={1: 30}, lease=0.4,
heartbeat_every=0.02)``). Each run must declare exactly rank 1 dead and
give the fault-free stream's blocks bit for bit. ``--device cpu --block
32`` runs it at a CPU-sized block.

Prints one line a run (wall, deaths, bit identity) and a summary; exits
1 if any run declared another rank dead or differed.

``--phase N`` then runs ``chip_smoke.py``'s whole ``phase_scheduler`` N
times on the card (the mixed 4 x 8 stream, its profiled rerun, the chained
streams and the overhead run, with every gate of the phase), since the
kill stream runs there after the mixed stream has filled the heap and the
card; it counts the runs whose gates all held.
"""

import argparse
import os
import subprocess
import sys
import time

import torch

from repro_torch.core.faults import FaultPlan
from repro_torch.sched import SchedulerService
from repro_torch.taskbench import (taskbench_blocks, taskbench_bodies,
                                   taskbench_graph)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def stream(g, blocks, bodies, n_chain, n_shards, dev, plan):
    with SchedulerService(n_shards, timeout=600.0, faults=plan,
                          device=dev) as svc:
        c = svc.client("chain")
        t0 = time.perf_counter()
        futs = [c.submit(g, blocks if j == 0 else {}, bodies)
                for j in range(n_chain)]
        outs = [f.result(svc.timeout) for f in futs]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    return outs, ms, svc.recovery_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--phase", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    width, depth, n_shards, n_chain = 16, 12, 4, 10
    g, _ = taskbench_graph("stencil", width, depth, n_shards, args.block,
                           seed=11)
    blocks = {k: torch.as_tensor(v, device=dev) for k, v in
              taskbench_blocks(width, depth, args.block, seed=11).items()}
    bodies = taskbench_bodies()
    ref, ms, _ = stream(g, blocks, bodies, n_chain, n_shards, dev, None)
    print(f"fault-free: {ms:.1f} ms", flush=True)
    bad = 0
    for i in range(args.runs):
        plan = FaultPlan(seed=11, kill={1: 30}, lease=0.4,
                         heartbeat_every=0.02)
        outs, ms, rep = stream(g, blocks, bodies, n_chain, n_shards, dev,
                               plan)
        same = all(o.keys() == r.keys() and
                   all(torch.equal(o[k], r[k]) for k in r)
                   for o, r in zip(outs, ref))
        ok = same and rep.deaths == [1]
        bad += not ok
        print(f"run {i}: {ms:.1f} ms, deaths {rep.deaths}, "
              f"rederived_shards {rep.rederived_shards}, bit for bit "
              f"{same}{'' if ok else '  <-- FAILED'}", flush=True)
    where = card() if dev.type == "cuda" else "cpu"
    print(f"soak: {args.runs - bad} of {args.runs} runs declared only rank 1 "
          f"dead and matched the fault-free stream [{where}]")
    if args.phase:
        bad += phase_runs(args.phase)
    return 1 if bad else 0


def phase_runs(n: int) -> int:
    """``chip_smoke.phase_scheduler`` ``n`` times; returns the failures."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from repro_torch.kernels import _build

    _build.build("block_gemm")
    failed = 0
    for i in range(n):
        t0 = time.perf_counter()
        try:
            chip_smoke.phase_scheduler(torch.device("cuda"))
            what = "every gate held"
        except RuntimeError as e:
            failed += 1
            what = f"FAILED: {e}"
        torch.cuda.empty_cache()
        print(f"phase run {i}: {time.perf_counter() - t0:.1f} s, {what}",
              flush=True)
    print(f"phase: {n - failed} of {n} runs of phase_scheduler passed "
          f"[{card()}]")
    return failed


if __name__ == "__main__":
    sys.exit(main())
