"""Plant known faults in copies of B1's, B3's and B4's CUDA sources and
check that ``chip_smoke.py``'s kernel checks catch each one.

    python scripts/torch_planted_faults.py

Run from the root of a checkout on a machine with one CUDA GPU and nvcc.
For each fault it copies ``src/`` and ``chip_smoke.py`` into a temporary
directory (outside the checkout, removed afterwards), edits one line of a
kernel's source there (every occurrence, where the fault's line occurs
more than once), and runs ``phase_build`` and the phase that holds
that kernel against its plain version, in a fresh process. A fault counts
as caught when that process fails with one of the smoke's checks. It
prints the failing check and the last kernel lines of each run, and exits
0 only if every fault is caught. The faults:

- B4 without the rescale of acc by alpha: needs a cache range of several
  tiles to show (the first tile's alpha is 1);
- B4 computing each tile on the ring's other stage (a stale or unfilled
  tile);
- B1 skipping its ragged last K step (``K // BK`` steps): needs a K that
  is not a multiple of BK;
- B3 without the state handed from chunk to chunk (H_c = 0): needs two
  chunks;
- B3's bf16 scores not masked for the 8 columns above the diagonal
  (L_ij for i < j <= i + 8);
- B3 mapping head h to group h % G instead of h / (H / G): needs G > 1
  and a group of more than one head;
- B3's tiles not zeroed past the data (the ragged last chunk's rows, the
  edges of N and P, the rows past a chunk shorter than its tile): the
  copies skipped leave stale shared memory there.
"""

import os
import shutil
import subprocess
import sys
import tempfile

FAULTS = {
    "B4 without acc's rescale by alpha": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        """#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }""", "", "phase_decode_vs_plain"),
    "B4 reading the ring's other stage": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "const __nv_bfloat16* ks = ring_s + (t % STAGES) * STAGE;",
        "const __nv_bfloat16* ks = ring_s + ((t + 1) % STAGES) * STAGE;",
        "phase_decode_vs_plain"),
    "B1 skipping its ragged last K step": (
        "src/repro_torch/kernels/csrc/block_gemm.cu",
        "const int n_k = (K + BK - 1) / BK;", "const int n_k = K / BK;",
        "phase_kernel_vs_plain"),
    "B3 without the state hand-off": (
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "const int n_inter = c > 0 ? p.Npd / TILE : 0;",
        "const int n_inter = 0;", "phase_ssd_vs_plain"),
    "B3 with L not masked above the diagonal": (
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "const int la = ra - jr, lb = rb - jr;",
        "const int la = ra - jr + 8, lb = rb - jr + 8;",
        "phase_ssd_vs_plain"),
    "B3 mapping head h to group h % G": (
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "g = h / (p.H / p.G);", "g = h % p.G;", "phase_ssd_vs_plain", 2),
    "B3 not zeroing its tiles past the data": (
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "cp_async16(dst + r * PT + col, live ? src + r * rs + col : safe, "
        "live);",
        "if (live) cp_async16(dst + r * PT + col, src + r * rs + col, true);",
        "phase_ssd_vs_plain"),
}


def run(name, path, old, new, phase, count=1) -> bool:
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree("src", os.path.join(tmp, "src"),
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        shutil.copy("chip_smoke.py", tmp)
        target = os.path.join(tmp, path)
        with open(target) as f:
            text = f.read()
        if text.count(old) != count:
            raise SystemExit(f"{name}: the line to change occurs "
                             f"{text.count(old)} times in {path}, not "
                             f"{count}")
        with open(target, "w") as f:
            f.write(text.replace(old, new))
        code = ("import torch, chip_smoke as c; "
                "torch.backends.cuda.matmul.allow_tf32 = False; "
                f"c.phase_build(); c.{phase}(torch.device('cuda'))")
        proc = subprocess.run([sys.executable, "-c", code], cwd=tmp,
                              capture_output=True, text=True, timeout=900)
    lines = (proc.stdout + proc.stderr).splitlines()
    failed = [line for line in lines if "chip_smoke: FAILED" in line]
    print(f"{name}: exit {proc.returncode}; "
          f"{failed[-1] if failed else 'no check failed'}", flush=True)
    for line in [line for line in lines if line.startswith("[kernel]")][-3:]:
        print(f"    {line[:160]}", flush=True)
    return proc.returncode != 0 and bool(failed)


def main():
    caught = sum(run(name, *fault) for name, fault in FAULTS.items())
    print(f"planted faults caught: {caught} of {len(FAULTS)}", flush=True)
    sys.exit(0 if caught == len(FAULTS) else 1)


if __name__ == "__main__":
    main()
