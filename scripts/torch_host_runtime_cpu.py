"""The host TaskTorrent runtime's own cost, and the active messages of
Cholesky-16k's DAG, on the CPU.

    PYTHONPATH=src python scripts/torch_host_runtime_cpu.py [--nb 32] [--b 4]

Runs ``run_host_ptg`` of ``cholesky_graph(nb, 2, 2, b)`` (4 ranks x 2
worker threads on ``inproc``) with block stores on the CPU, twice: with the
port's torch bodies, and with bodies that return their first operand (the
runtime alone: task scheduling, dependency counting, AMs and their tensor
copies, completion detection). The DAG does not depend on ``b``: at nb 32
it is ``chip_smoke.py``'s cholesky-16k-host (b 512), so the task counts and
the AMs per rank pair printed here are that cell's; each AM carries one
b x b block. Wall times are this machine's host clock, not a device time.
"""

import argparse
import time

from repro_torch.core import payload_stats
from repro_torch.linalg.cholesky import (cholesky_bodies, cholesky_graph,
                                         make_spd_blocks)
from repro_torch.linalg.host_exec import run_host_ptg


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nb", type=int, default=32)
    ap.add_argument("--b", type=int, default=4)
    args = ap.parse_args()
    nb, b = args.nb, args.b
    spec = cholesky_graph(nb, 2, 2, b).to_block_spec()
    counts = {}
    for k in (k for v in spec.views for k in v.tasks):
        counts[spec.ptg.type_of(k)] = counts.get(spec.ptg.type_of(k), 0) + 1
    n_tasks = sum(counts.values())
    print(f"cholesky nb={nb} b={b} 2x2: {n_tasks} tasks {counts}")
    blocks, _ = make_spd_blocks(nb, b)
    identity = {t: (lambda *ops: ops[0]) for t in counts}
    for label, bodies in (("torch bodies", cholesky_bodies()),
                          ("runtime alone", identity)):
        payload_stats.reset()
        t0 = time.perf_counter()
        run_host_ptg(spec, blocks, bodies, device="cpu")
        wall = time.perf_counter() - t0
        print(f"{label}: {wall:.3f} s, {1e6 * wall / n_tasks:.0f} us a "
              f"task; AMs {sum(n for n, _ in payload_stats.pairs.values())}"
              f", tensors copied {payload_stats.copied}, pickled "
              f"{payload_stats.pickled}")
    print("AMs per rank pair (src->dst): " + ", ".join(
        f"{s}->{d} {n}" for (s, d), (n, _) in
        sorted(payload_stats.pairs.items())))


if __name__ == "__main__":
    main()
