"""Reads a cell's compared number with a fault planted under the timed
path, or with the control in the program's place, at the cell's own size,
on several seeds, in one process:

    python3 portbench/control.py --workload <cell> --plant control \\
        --seeds 1 2 3 --seconds 3

``--plant`` is ``control`` (the plain reference in TF32), a fault of
``faults.FAULTS``, or ``none`` (the program as it runs). Each run prints
one JSON line: the seed, the plant, ``correct`` and ``checked``. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plant", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from portbench import loop

    for seed in args.seeds:
        out = loop.run_cell(args.workload, seed, args.seconds, False,
                            start_epoch=time.time(),
                            plant=None if args.plant == "none" else args.plant)
        print(json.dumps({"seed": seed, "plant": args.plant,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checked": out["checked"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
