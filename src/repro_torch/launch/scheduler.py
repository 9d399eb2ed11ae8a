"""Scheduler-service launcher: a resident multi-tenant submission demo (the
port's copy of the JAX package's ``repro.launch.scheduler``).

    python -m repro_torch.launch.scheduler --shards 2 --clients 4 \
        --submissions 8 --verify [--device cpu]

Starts one :class:`repro_torch.sched.SchedulerService` (ranks stay
resident between submissions, block stores on ``--device``, ``cuda``
unless ``--device cpu``), registers N clients with distinct fair-share
weights, and streams M submissions per client into it concurrently —
cycling through the Task-Bench dependence patterns plus a blocked
Cholesky as the linalg family. On the card the Cholesky's syrk and gemm
tasks launch the B1 ``block_gemm`` kernel, one launch a task.
``--verify`` replays every distinct graph through the one-shot
``Graph.run_host`` path on the same device and checks the stream's
results are bit-identical; the exit prints per-client accounting (tasks /
bytes / wall) and the service's retirement stats (``live_frac`` near 0
means memory tracked the live frontier, not the stream's history).

``--block`` (default 4) is the Cholesky's block edge and ``--tb-block``
(default 8) the Task-Bench blocks'; the defaults are the JAX package's.

Chaos mode exercises the survivable-stream machinery:

    python -m repro_torch.launch.scheduler --kill 1:40 --chaos 0.1 --verify

``--kill RANK:AT_MSG`` crashes a resident rank at its AT_MSG-th user AM
send; ``--chaos P`` adds P message loss and duplication on every edge;
``--deadline S`` bounds each submission's life. The exit then prints the
:class:`~repro_torch.core.faults.RecoveryReport` — replayed bus commands
and sends, re-executed tasks, forwarded AMs — plus ``sched_recover_ms``
(death declaration -> the at-death in-flight set drained).
"""

import argparse
import threading
import time

import torch


def stream_inputs(device, transport=None, *, width: int, depth: int,
                  nb: int, b: int = 4, tb_b: int = 8, seed: int = 7):
    """The blocks and bodies :func:`run_stream` submits to a service on
    ``device`` and ``transport``, on that device: ``(tb_blocks, tb_bodies,
    ch_blocks, ch_bodies)``. Task-Bench blocks are numpy draws from
    ``seed``; the Cholesky matrix too on the CPU (the JAX package's
    numbers), and on the card a ``torch.Generator`` draw there
    (``make_spd_blocks(device=)``: the host product would take minutes at
    paper scale). On the card syrk and gemm run B1 (``block_gemm.ops
    .matmul``); ``multiproc`` runs the numpy Cholesky bodies (forked ranks
    run no torch kernels of the parent's)."""
    from repro_torch.kernels.block_gemm.ops import matmul
    from repro_torch.linalg.cholesky import (cholesky_bodies,
                                             cholesky_bodies_numpy,
                                             make_spd_blocks)
    from repro_torch.linalg.host_exec import to_store
    from repro_torch.taskbench import taskbench_blocks, taskbench_bodies

    dev = torch.device(device)
    tb_blocks = {k: to_store(v, dev) for k, v in
                 taskbench_blocks(width, depth, tb_b, seed=seed).items()}
    ch_blocks, _ = make_spd_blocks(
        nb, b, seed=seed, device=dev if dev.type == "cuda" else None)
    ch_blocks = {k: to_store(v, dev) for k, v in ch_blocks.items()}
    ch_bodies = cholesky_bodies_numpy() if transport == "multiproc" \
        else cholesky_bodies(matmul=matmul)
    return tb_blocks, taskbench_bodies(), ch_blocks, ch_bodies


def run_stream(svc, n_clients: int, n_submissions: int, *, width: int,
               depth: int, nb: int, seed: int = 7,
               deadline: float = None, b: int = 4, tb_b: int = 8,
               inputs=None):
    """Drive ``n_clients`` concurrent client threads, each submitting
    ``n_submissions`` mixed PTGs (Task-Bench patterns + Cholesky, each in
    a fresh namespace). Returns ``{client: [(kind, result_blocks)]}``;
    a submission shed by its ``deadline`` yields ``(kind, None)``.
    ``inputs`` (:func:`stream_inputs`' tuple) skips making them here."""
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.taskbench import taskbench_graph

    patterns = ("stencil", "fft", "tree", "random")
    n = svc.n_shards
    tb_blocks, tb_bodies, ch_blocks, ch_bodies = inputs or stream_inputs(
        svc.device, svc.transport, width=width, depth=depth, nb=nb, b=b,
        tb_b=tb_b, seed=seed)
    results: dict = {}

    def client_thread(name: str, weight: float) -> None:
        from repro_torch.sched import DeadlineExceeded

        c = svc.client(name, weight=weight)
        futs = []
        for j in range(n_submissions):
            ns = f"{name}/{j}"
            if j % len(patterns) == len(patterns) - 1 and j:
                futs.append(("cholesky", c.submit(
                    cholesky_graph(nb, n, 1, b), ch_blocks, ch_bodies,
                    namespace=ns, deadline=deadline)))
            else:
                p = patterns[j % len(patterns)]
                g, _ = taskbench_graph(p, width, depth, n, tb_b, seed=seed)
                futs.append((p, c.submit(g, tb_blocks, tb_bodies,
                                         namespace=ns, deadline=deadline)))
        out = []
        for kind, f in futs:
            try:
                out.append((kind, f.result(svc.timeout)))
            except DeadlineExceeded:
                out.append((kind, None))   # cleanly shed, never a hang
        results[name] = out

    threads = [threading.Thread(target=client_thread,
                                args=(f"client{i}", float(i + 1)),
                                daemon=True)
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def one_shot_refs(svc, kinds, *, width: int, depth: int, nb: int,
                  n_threads: int = 2, seed: int = 7, b: int = 4,
                  tb_b: int = 8, inputs=None) -> dict:
    """``{kind: blocks}``: each distinct graph of :func:`run_stream` run
    once through the one-shot ``Graph.run_host`` (``inproc``) on the
    service's device, with the stream's inputs and bodies — the oracle the
    stream's results must equal bit for bit."""
    from repro_torch.linalg.cholesky import cholesky_graph
    from repro_torch.taskbench import taskbench_graph

    tb_blocks, tb_bodies, ch_blocks, ch_bodies = inputs or stream_inputs(
        svc.device, svc.transport, width=width, depth=depth, nb=nb, b=b,
        tb_b=tb_b, seed=seed)
    kw = dict(n_threads=n_threads, device=svc.device)
    refs = {}
    for kind in sorted(kinds):
        if kind == "cholesky":
            refs[kind] = cholesky_graph(nb, svc.n_shards, 1, b).run_host(
                ch_blocks, ch_bodies, **kw)
        else:
            g, _ = taskbench_graph(kind, width, depth, svc.n_shards, tb_b,
                                   seed=seed)
            refs[kind] = g.run_host(tb_blocks, tb_bodies, **kw)
    return refs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--submissions", type=int, default=8,
                    help="PTGs per client")
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--nb", type=int, default=4,
                    help="Cholesky blocks per dimension")
    ap.add_argument("--block", type=int, default=4,
                    help="Cholesky block edge")
    ap.add_argument("--tb-block", type=int, default=8,
                    help="Task-Bench block edge")
    ap.add_argument("--threads", type=int, default=2,
                    help="worker threads per rank")
    ap.add_argument("--device", default="cuda",
                    help="where the blocks live (cuda unless 'cpu')")
    ap.add_argument("--verify", action="store_true",
                    help="check bit-identity against one-shot executions")
    ap.add_argument("--kill", default=None, metavar="RANK:AT_MSG",
                    help="crash a resident rank at its AT_MSG-th AM send")
    ap.add_argument("--chaos", type=float, default=0.0, metavar="P",
                    help="message loss AND duplication probability")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-submission deadline in seconds")
    ap.add_argument("--seed", type=int, default=0,
                    help="fault-injection RNG seed")
    ap.add_argument("--transport", default=None,
                    choices=("inproc", "multiproc"),
                    help="comm backend the resident ranks run on "
                         "(multiproc = one OS process per rank, --device "
                         "cpu only)")
    args = ap.parse_args()

    from repro_torch.sched import SchedulerService

    plan = None
    if args.kill or args.chaos:
        from repro_torch.core.faults import FaultPlan

        kill = {}
        if args.kill:
            rank, at = args.kill.split(":")
            kill[int(rank)] = int(at)
        plan = FaultPlan(seed=args.seed, drop=args.chaos,
                         duplicate=args.chaos, kill=kill)

    sizes = dict(width=args.width, depth=args.depth, nb=args.nb,
                 b=args.block, tb_b=args.tb_block)
    t0 = time.monotonic()
    with SchedulerService(args.shards, n_threads=args.threads,
                          timeout=300.0, faults=plan,
                          transport=args.transport,
                          device=args.device) as svc:
        results = run_stream(svc, args.clients, args.submissions,
                             deadline=args.deadline, **sizes)
    if svc.device.type == "cuda":
        torch.cuda.synchronize(svc.device)
    wall = time.monotonic() - t0
    stats = svc.stats()

    total_subs = sum(len(v) for v in results.values())
    print(f"{args.clients} clients x {args.submissions} submissions on "
          f"{args.shards} resident shards ({svc.device}): {total_subs} PTGs "
          f"in {wall:.2f}s")
    for name in sorted(results):
        cs = stats["clients"][name]
        print(f"  {name}: {cs['completed']} completed, {cs['tasks']} tasks, "
              f"{cs['bytes']} bytes, {cs['wall_seconds']:.2f}s wall")
    print(f"retirement: blocks_hwm={stats['blocks_hwm']} / "
          f"blocks_total={stats['blocks_total']} "
          f"(live_frac={stats['live_frac']:.3f})")
    shed = sum(1 for rows in results.values() for _, out in rows
               if out is None)
    if shed:
        print(f"shed: {shed} submissions hit their deadline (clean "
              "DeadlineExceeded, no hangs)")
    if plan is not None and svc.recovery_report is not None:
        r = svc.recovery_report.to_dict()
        cap = svc.capacity()
        print(f"recovery: deaths={r['deaths']} "
              f"bus_replayed={r['bus_replayed']} "
              f"replayed_sends={r['replayed_sends']} "
              f"reexecuted_tasks={r['reexecuted_tasks']} "
              f"forwarded_ams={r['forwarded_ams']} "
              f"retries={r['retries']} dup_suppressed={r['dup_suppressed']}")
        if cap["sched_recover_ms"] is not None:
            print(f"recovery: sched_recover_ms="
                  f"{cap['sched_recover_ms']:.1f} "
                  f"(live_ranks={cap['live_ranks']}/{cap['n_shards']})")

    if args.verify:
        refs = one_shot_refs(
            svc, {k for rows in results.values() for k, _ in rows},
            n_threads=args.threads, **sizes)
        for name, rows in results.items():
            for kind, out in rows:
                if out is None:
                    continue   # shed by deadline: nothing to compare
                for blk, v in out.items():
                    assert torch.equal(v, refs[kind][blk]), \
                        (name, kind, blk)
        print(f"verify: all {total_subs} submissions bit-identical to "
              f"one-shot executions")


if __name__ == "__main__":
    main()
