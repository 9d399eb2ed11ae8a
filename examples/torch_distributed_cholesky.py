"""The paper's flagship app end-to-end (PyTorch port): distributed blocked
Cholesky declared ONCE via the ``repro_torch.ptg`` front-end and executed
on BOTH backends from that single definition —

  (a) the host TaskTorrent runtime: async tasks + work stealing + one-sided
      active messages + distributed completion detection, block stores on
      the device;
  (b) the compiled block executor: parallel DAG discovery -> wavefront
      schedule -> every shard stacked on the one device, classified
      sparse/dense exchanges as on-device index copies, the trailing
      updates through the block_gemm kernel;
  (c) with ``--ranks N`` (N = the grid's shards), the same executor with
      one process per shard (``repro_torch.dist.ranks``): each rank runs
      its own shard, and the exchanges are gloo collectives between the
      processes, staged through host memory on the card.

The port's counterpart of ``examples/distributed_cholesky.py``; on
``cuda`` unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_distributed_cholesky.py --nb 8 \
      --block 32 [--device cpu] [--ranks 4]
"""

import argparse
import time

import torch

from repro_torch.dist.ranks import owned_blocks, spawn_ranks
from repro_torch.kernels.block_gemm.ops import matmul, task_matmul
from repro_torch.linalg.cholesky import (assemble_lower, cholesky_bodies,
                                         cholesky_executor, cholesky_graph,
                                         cholesky_rank, make_spd_blocks)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nb", type=int, default=8)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--grid", type=int, nargs=2, default=(2, 2))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0,
                    help="also run the executor with one process per shard")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("distributed_cholesky: no CUDA device (pass "
                         "--device cpu to run on the CPU)")
    pr, pc = args.grid
    nb, b = args.nb, args.block
    n = nb * b
    if args.ranks and args.ranks != pr * pc:
        raise SystemExit(f"distributed_cholesky: --ranks {args.ranks} != "
                         f"{pr * pc} shards of the {pr}x{pc} grid")

    graph = cholesky_graph(nb, pr, pc, b)   # ONE declarative definition
    blocks, a = make_spd_blocks(nb, b)
    want = torch.linalg.cholesky(torch.as_tensor(a, dtype=torch.float64))

    def err(blocks_out):
        got = assemble_lower(blocks_out, nb, b).double().cpu()
        return float((got - want).abs().max())

    # (a) host runtime, wired from the derived out-edges
    t0 = time.perf_counter()
    host = graph.run_host(blocks, cholesky_bodies(matmul), n_threads=2,
                          device=device)
    t_host = time.perf_counter() - t0
    print(f"[host runtime]  N={n} on {pr}x{pc} ranks: {t_host * 1e3:7.1f} ms"
          f"  max|err|={err(host):.2e}")

    # (b) the compiled executor: classified sparse exchange + comm/compute
    # overlap, every shard on the one device
    prog = graph.to_program()
    run = cholesky_executor(prog, matmul=task_matmul, device=device)
    packed = prog.pack(blocks, device=device)
    run(packed)                                              # warm-up
    _sync(device)
    t0 = time.perf_counter()
    out = prog.unpack(run(prog.pack(blocks, device=device)))
    _sync(device)
    t_comp = time.perf_counter() - t0
    print(f"[compiled]      N={n} on {pr * pc} shards: "
          f"{t_comp * 1e3:7.1f} ms  max|err|={err(out):.2e}")
    st = prog.comm_stats(comm="auto")
    dense = prog.comm_stats(comm="dense")
    print(f"schedule: {prog.schedule.n_wavefronts} wavefronts | wire "
          f"{st['real_bytes'] / 1e6:.2f} MB real / "
          f"{st['padded_bytes'] / 1e6:.2f} MB padded "
          f"(efficiency {st['wire_efficiency']:.2f} vs "
          f"{dense['wire_efficiency']:.2f} dense all_to_all)")

    if args.ranks:
        # (c) one process per shard: each packs its own shard of the same
        # seeded matrix, and returns its L blocks
        runs = [{"name": "auto", "auto": True, "warmup": 1}]
        t0 = time.perf_counter()
        ranks = spawn_ranks(cholesky_rank, args.ranks, nb, pr, pc, b, runs,
                            device=device, kernel=True, keep=("L",))
        t_spawn = time.perf_counter() - t0
        got = owned_blocks(prog, [res[0] for res in ranks])
        print(f"[ranks]         N={n} on {args.ranks} processes "
              f"({ranks[0][0]['mode']}): "
              f"{max(r[0]['wall_ms'] for r in ranks):7.1f} ms  "
              f"max|err|={err(got):.2e}  (spawn and run {t_spawn:.1f} s)")
        for res in ranks:
            run = res[0]
            print(f"  rank {run['rank']}: exchange {run['exchange_ms']:.1f} "
                  f"ms, bodies {run['body_ms']:.1f} ms, bytes sent per peer "
                  f"{run['sent_bytes']}, staged {run['staged_bytes']}")


if __name__ == "__main__":
    main()
