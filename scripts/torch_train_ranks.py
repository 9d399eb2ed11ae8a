"""Run ``chip_smoke.py``'s ranked training phase alone on the GPU, several
times: ``phase_train_ranks`` (starcoder2-3b-d10-train-tp4-r4 at full
width, 10 of its 30 layers, on a (1, 4) mesh of rank processes that share
the card,
starcoder2-3b-d4-train-dp2-tp2-r4, 4 of its 30 layers in f32 on (2, 2),
with the configs' bf16 parameters and Adafactor
grok-1-314b-d2-train-tp4-r4 and deepseek-v3-671b-d3-train-tp4-r4 on (1,
4), and in f32 zamba2-1.2b-d13-train-tp4-r4 (13 of 38 layers, two shared
sites) and seamless-m4t-large-v2-d6-train-tp4-r4 (6 + 6 of 24 + 24
layers, 2 048 frames and 512 tokens, the embedding and head split on
d_model) on (1, 4), each against its one-process yardstick, with every
gate of the phase), then the range of each cell's ms a step over the
repeats.

    python3 scripts/torch_train_ranks.py [--repeats N] [cell ...]
    python3 scripts/torch_train_ranks.py --plant NAME [--plant NAME ...]

Names of cells pick some, run in that order (all by default). Needs one
CUDA GPU and nvcc (the ranks build the kernels before they start). Prints
what the phase prints, with the card's name and power limit on every line
of numbers.

``--plant`` is a mutation check of the f32 cell's first-update gate: for
each named fault (``PLANTS``) it copies ``src/``, ``scripts/`` and
``chip_smoke.py`` into a temporary directory, plants the fault in the
copy, runs starcoder2-3b-d4-train-dp2-tp2-r4 there once, and prints each
rank's gradient and update readings. It exits 0 only if the gate failed
every planted fault.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


# name -> (file, text, the text planted in its place): faults the f32
# cell's gates must catch. Megatron's f without its all-reduce; f's sum
# taken on gradients rounded to bf16; each data rank's loss over its own
# label count instead of the global batch's.
F_SUM = "return _sum(ctx.mesh, g.to(_wide(g), copy=True)).to(g.dtype), None"
PLANTS = {
    "f-unsummed": ("src/repro_torch/dist/tensor_parallel.py", F_SUM,
                   "return g, None"),
    "f-sum-bf16": ("src/repro_torch/dist/tensor_parallel.py", F_SUM,
                   "return _sum(ctx.mesh, g.to(torch.bfloat16).to("
                   "_wide(g))).to(g.dtype), None"),
    "local-count": ("src/repro_torch/train/train_step.py",
                    'return (part["labels"] >= 0).float().sum()',
                    "return None"),
}
GATED = "starcoder2-3b-d4-train-dp2-tp2-r4"


def plant(names) -> int:
    """Run the f32 cell once on a copy of the checkout with each fault of
    ``names`` planted; 0 if its gates failed every one."""
    missed = []
    for name in names:
        path, text, fault = PLANTS[name]
        tmp = tempfile.mkdtemp(prefix=f"plant-{name}-")
        try:
            for part in ("src", "scripts"):
                shutil.copytree(os.path.join(ROOT, part),
                                os.path.join(tmp, part),
                                ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
            with open(os.path.join(tmp, path)) as fh:
                code = fh.read()
            if code.count(text) != 1:
                raise RuntimeError(f"{name}: {text!r} not once in {path}")
            with open(os.path.join(tmp, path), "w") as fh:
                fh.write(code.replace(text, fault))
            run = subprocess.run(
                [sys.executable, os.path.join(tmp, "scripts",
                                              "torch_train_ranks.py"),
                 "--repeats", "1", GATED], cwd=tmp, capture_output=True,
                text=True, timeout=900)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        said = [line for line in (run.stdout + run.stderr).splitlines()
                if "first step against" in line or "losses [" in line
                or "FAILED" in line]
        cs.log(f"[plant] {name}: exit {run.returncode}")
        for line in said:
            cs.log(f"[plant] {name}: {line[:600]}")
        if run.returncode == 0 or not any("FAILED" in x for x in said):
            missed.append(name)
    cs.log(f"[plant] the gates caught {len(names) - len(missed)} of "
           f"{len(names)} planted faults; missed {missed} [{cs.card()}]")
    return 1 if missed else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--plant", action="append", choices=sorted(PLANTS))
    ap.add_argument("cells", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_ranks: needs a CUDA GPU", file=sys.stderr)
        return 1
    if args.plant:
        return plant(args.plant)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cs.log(cs.card())
    cells = [c for n in args.cells for c in cs.TRAIN_TP_CELLS
             if c[0] == n] or cs.TRAIN_TP_CELLS
    runs = [cs.phase_train_ranks(dev, cells=cells)
            for _ in range(args.repeats)]
    for cell in cells:
        got = [r[cell[0]] for r in runs]
        ms = sorted(g["ms"] for g in got)
        one = sorted(g["one_ms"] for g in got)
        share = sorted(s for g in got for s in g["reduce_share"])
        cs.log(f"[train ranks] {cell[0]} over {len(got)} runs: "
               f"{ms[0]:.1f}-{ms[-1]:.1f} ms a step (one process "
               f"{one[0]:.1f}-{one[-1]:.1f}), all-reduce {share[0]:.1%}-"
               f"{share[-1]:.1%} of a rank's wall, peak a rank "
               f"{max(p for g in got for p in g['peak_gb']):.2f} GB "
               f"[{cs.card()}]")
    cs.log(f"[train ranks] total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
