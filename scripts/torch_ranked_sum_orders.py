"""A ranked train cell of ``chip_smoke.py``'s ``phase_train_ranks`` under
several orders of the device transport's all-reduce sum, and on gloo, on
the GPU: whether each passes the cell's gates, and, where one fails, the
first gradient elements past them (leaf, index, one process's value, the
ranks', one bf16 ulp of it, the 1e-5-of-max floor).

The orders, on every member the same expression over the members' f32
copies in the group's rank order: ``tree`` (the transport's own,
``(t0 + t1) + (t2 + t3)``), ``chain`` (``((t0 + t1) + t2) + t3``) and
``f64`` (the sum in f64, rounded once to f32: the exact sum of the
partials); ``gloo`` is gloo's own all-reduce through host memory.

    python3 scripts/torch_ranked_sum_orders.py [--orders tree chain f64 gloo]
        [cell ...]

The default cell is deepseek-v3-671b-d3-train-tp4-r4 (~40 s an order on
an H100). Needs one CUDA GPU.
"""

import argparse
import functools
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from repro_torch.dist import ranks  # noqa: E402

_tree = ranks.DeviceTensorTransport._sum


def _sum(parts, out):
    """The transport's sum in the order ``SUM_ORDER`` names (read at each
    call: a rank process takes the parent's environment at the call)."""
    order = os.environ.get("SUM_ORDER", "tree")
    if order == "chain":
        torch.add(parts[0], parts[1], out=out)
        for x in parts[2:]:
            out.add_(x)
    elif order == "f64":
        acc = parts[0].double()
        for x in parts[1:]:
            acc += x.double()
        out.copy_(acc)
    else:
        _tree(parts, out)


# at import, so that every rank process (which imports this script as its
# main module) sums the same way
ranks.DeviceTensorTransport._sum = staticmethod(_sum)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*",
                    default=["deepseek-v3-671b-d3-train-tp4-r4"])
    ap.add_argument("--orders", nargs="+", default=["tree", "chain", "f64",
                                                    "gloo"],
                    choices=("tree", "chain", "f64", "gloo"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ranked_sum_orders: needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cells = [c for c in cs.TRAIN_TP_CELLS if c[0] in args.cells]
    if len(cells) != len(args.cells):
        sys.exit(f"unknown cells in {args.cells}")
    print(cs.card(), flush=True)
    check_transport, failed = cs.check_transport, []
    for order in args.orders:
        gloo = order == "gloo"
        os.environ["SUM_ORDER"] = "tree" if gloo else order
        cs.spawn_ranks = functools.partial(ranks.spawn_ranks,
                                           transport="gloo" if gloo
                                           else "device")
        cs.check_transport = (functools.partial(check_transport, want="gloo")
                              if gloo else check_transport)
        print(f"=== {order}", flush=True)
        try:
            cs.phase_train_ranks(dev, cells=cells)
            print(f"PASS {order}", flush=True)
        except RuntimeError as exc:
            failed.append(order)
            print(f"FAIL {order}: {exc}", flush=True)
    print(f"orders that failed a gate: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
