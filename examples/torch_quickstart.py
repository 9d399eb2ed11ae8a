"""Quickstart (PyTorch port): declare a PTG once, run it on both back-ends.

The port's counterpart of ``examples/quickstart.py``, on ``repro_torch``:

1. Declare the graph — task types with index spaces plus the blocks each
   task reads/writes and an owner mapping. ``in_deps``/``out_deps``/
   ``operands``/``indegree``/seeds are all *derived*.
2. Lower the SAME definition to
   (a) the host runtime: async Taskflow + one-sided active messages
       generated from the derived out-edges, block stores on the device;
   (b) the compiled executor: parallel DAG discovery -> wavefront schedule
       -> the single-device block executor, every shard stacked on the
       device, the trailing updates through the block_gemm kernel (its
       plain version on the CPU).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(on ``cuda`` unless ``--device cpu``).
"""

import argparse

import torch

from repro_torch.ptg import Graph


def declare_chain(n_ranks: int, chain: int) -> Graph:
    """A ring of accumulating tasks: task k reads block k-1, writes block
    k, on rank k mod n_ranks — every hand-off is a cross-rank active
    message on the host backend."""
    g = Graph("chain", n_shards=n_ranks, owner=lambda blk: blk[1] % n_ranks,
              block_shape=(1, 1))
    g.task_type("acc",
                space=lambda: ((k,) for k in range(chain)),
                writes=lambda k: ("v", k),
                reads=lambda k: [("v", k - 1)] if k else [])
    return g


def host_runtime_demo(device):
    n_ranks, chain = 3, 12
    g = declare_chain(n_ranks, chain)
    # derived structure: one seed, a pure chain
    assert g.seeds == [("acc", 0)]
    assert g.out_deps(("acc", 4)) == [("acc", 5)]

    blocks = {("v", k): torch.zeros((1, 1)) for k in range(chain)}
    zero = torch.zeros((1, 1), device=device)
    bodies = {"acc": lambda *prev: (prev[0] if prev else zero) + 1.0}
    out = g.run_host(blocks, bodies, n_threads=2, device=device)
    total = float(out[("v", chain - 1)])
    assert total == chain, total
    print(f"[host runtime] chain of {chain} tasks across {n_ranks} ranks: "
          f"final value {total:.0f} (one AM per hand-off)")


def compiled_backend_demo(device):
    from repro_torch.kernels.block_gemm.ops import matmul, task_matmul
    from repro_torch.linalg.cholesky import (assemble_lower, cholesky_bodies,
                                             cholesky_executor,
                                             cholesky_graph, make_spd_blocks)

    pr = pc = 2
    nb, b = 4, 16
    # ONE declarative definition (4 task types + reads/writes accesses)...
    graph = cholesky_graph(nb, pr, pc, b)
    blocks, a = make_spd_blocks(nb, b)

    # ...two lowerings. (a) host runtime, one block a task (block_gemm on
    # each syrk/gemm block):
    host = graph.run_host(blocks, cholesky_bodies(matmul), device=device)
    l_host = assemble_lower(host, nb, b)

    # (b) compiled executor, every shard on the one device (block_gemm
    # batched over each wavefront's tasks):
    prog = graph.to_program()
    run = cholesky_executor(prog, matmul=task_matmul, device=device)
    comp = prog.unpack(run(prog.pack(blocks, device=device)))
    l_comp = assemble_lower(comp, nb, b)

    a = torch.as_tensor(a, device=device, dtype=l_comp.dtype)
    err = float((l_comp @ l_comp.T - a).abs().max())
    agree = float((l_comp - l_host).abs().max())
    print(f"[one graph, two backends] {nb}x{nb}-block Cholesky on "
          f"{pr * pc} shards: |LL^T - A|_max = {err:.2e}, "
          f"|host - compiled|_max = {agree:.2e}")
    assert err < 1e-4 and agree < 1e-4, (err, agree)
    stats = prog.comm_stats(comm="auto")
    print(f"  schedule: {prog.schedule.n_wavefronts} wavefronts, "
          f"{stats['real_bytes'] / 1e3:.1f} KB on the wire, efficiency "
          f"{stats['wire_efficiency']:.2f} (classified sparse exchange)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quickstart: no CUDA device (pass --device cpu to "
                         "run on the CPU)")
    host_runtime_demo(device)
    compiled_backend_demo(device)


if __name__ == "__main__":
    main()
