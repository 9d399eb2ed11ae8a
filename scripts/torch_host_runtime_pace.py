"""What sets the pace of Cholesky-16k on the host TaskTorrent runtime, on
one CUDA GPU.

    PYTHONPATH=src python scripts/torch_host_runtime_pace.py [--nb 32]

Runs ``chip_smoke.py``'s cholesky-16k-host cell (``run_host_ptg`` of
``cholesky_graph(nb, 2, 2, 512)`` on ``inproc``, block stores on the card)
under variants, each twice, wall time on the host clock (ending in a
synchronise):

- ``base``: 2 worker threads a rank, B1 bodies (``ops.matmul``);
- ``1 thread``: 1 worker thread a rank;
- ``switch 0.1 ms``: ``sys.setswitchinterval(1e-4)`` (Python hands the
  GIL on every 0.1 ms instead of 5 ms);
- ``torch.matmul``: the syrk/gemm bodies through ``torch.matmul`` instead
  of B1;
- ``identity``: bodies that return their first operand (the runtime
  alone).

Then the host cost of one body call without the runtime: the gemm body
``a - matmul(li, lj.mT)`` called 2 000 times in one thread, with B1 and with
``torch.matmul``, host clock per call and CUDA-event time per call.
"""

import argparse
import sys
import time

import torch

from repro_torch.kernels.block_gemm.ops import matmul
from repro_torch.linalg.cholesky import (cholesky_bodies, cholesky_graph,
                                         make_spd_blocks)
from repro_torch.linalg.host_exec import run_host_ptg


def wall_ms(spec, blocks, bodies, n_threads=2) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_host_ptg(spec, blocks, bodies, n_threads=n_threads, timeout=600.0,
                 device="cuda")
    return 1e3 * (time.perf_counter() - t0)


def body_cost(mm, n=2000, b=512):
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, li, lj = (torch.randn((b, b), generator=gen, device="cuda")
                 for _ in range(3))
    a - mm(li, lj.mT)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        a - mm(li, lj.mT)
    end.record()
    host_us = 1e6 * (time.perf_counter() - t0) / n
    end.synchronize()
    return host_us, 1e3 * start.elapsed_time(end) / n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nb", type=int, default=32)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    nb, b = args.nb, 512
    spec = cholesky_graph(nb, 2, 2, b).to_block_spec()
    blocks, _ = make_spd_blocks(nb, b, seed=0, device="cuda")
    types = ("potrf", "trsm", "syrk", "gemm")
    b1 = cholesky_bodies(matmul=matmul)
    variants = [
        ("base", b1, 2, None),
        ("1 thread", b1, 1, None),
        ("switch 0.1 ms", b1, 2, 1e-4),
        ("torch.matmul", cholesky_bodies(matmul=torch.matmul), 2, None),
        ("identity", {t: (lambda *ops: ops[0]) for t in types}, 2, None),
    ]
    wall_ms(spec, blocks, b1)                                   # warm-up
    default = sys.getswitchinterval()
    for label, bodies, n_threads, switch in variants:
        sys.setswitchinterval(switch or default)
        times = [wall_ms(spec, blocks, bodies, n_threads) for _ in range(2)]
        sys.setswitchinterval(default)
        print(f"[pace] {label:<14} {times[0]:9.1f} {times[1]:9.1f} ms",
              flush=True)
    for label, mm in (("B1", matmul), ("torch.matmul", torch.matmul)):
        host_us, dev_us = body_cost(mm)
        print(f"[pace] gemm body alone, {label:<12}: host {host_us:.1f} us, "
              f"device {dev_us:.1f} us a call", flush=True)


if __name__ == "__main__":
    main()
