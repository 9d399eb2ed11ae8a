"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. Prints, as its last line on standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; last, ``checked``,
each number compared with its limit, which also ends standard error. Exits
with another code than 0, and prints no result, where there is no card or
too few, or where a process of the run held JAX or the JAX package.
"""

from __future__ import annotations

import time

START_EPOCH = time.time()      # the process's start, for ``setup_s``

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# every cache a library may keep lives at a fixed place in the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / ".portbench_cache" / _sub)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return got.stdout.strip().splitlines()[0] if got.returncode == 0 \
        and got.stdout.strip() else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import loop, spec

    bench = spec.benchmark()
    chips = spec.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"cuda available {torch.cuda.is_available()}, devices "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = loop.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), start_epoch=START_EPOCH,
                        bench=bench)
    forbidden = out.pop("forbidden")
    notes = out.pop("notes")
    if forbidden:
        print(f"portbench: the run held {forbidden} once the window had "
              "closed; no result", file=sys.stderr)
        return 3
    out["device"]["power"] = power_limit()
    checked = out.pop("checked")
    out["checked"] = checked          # the last key of the line
    for line in notes:
        print(f"portbench: {line}", file=sys.stderr)
    for name, got in checked.items():
        if isinstance(got, dict):
            print(f"checked {name} {got['value']!r} limit {got['limit']!r}",
                  file=sys.stderr)
    print(f"checked steps {checked['steps_checked']}, correct "
          f"{out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
