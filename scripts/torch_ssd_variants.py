"""Time variants of the hand-written B3 (ssd_scan) kernels on the GPU, to see
where a call's time goes and which design choice holds it back.

    PYTHONPATH=src python scripts/torch_ssd_variants.py [--rounds 2]

Needs one CUDA GPU and nvcc. Each variant is a copy of
``src/repro_torch/kernels/csrc/ssd_scan.cu`` with a few lines changed,
built with ``nvcc -Xptxas -v`` into ``kernels/_build/variants/`` and loaded
in place of the built library, so the port's own wrapper launches it. Two
kinds of variant: deeper rings of shared tiles (the results stay right),
and ablations that drop one part of a kernel (its products, or its stores
made conditional on a value the data never takes) to see what that part
costs: their results are wrong, and their error is printed as such. For
each variant the script prints the registers and spill bytes ptxas reports
for ``ssd_state`` and ``ssd_out``, its largest error against the plain
version, the time of a whole call (CUDA events) and, from
``torch.profiler``, the device time of each of the four kernels, round
after round. Shape: mamba2-1.3b's layer at prefill (x [4, 2048, 64, 64],
B/C [4, 2048, 1, 128], bf16, Q 128) in the model's layout (x, B and C
views of one projection).
"""

import argparse
import ctypes
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ssd_chunked_ref, ssd_scan

SSD = sys.modules["repro_torch.kernels.ssd_scan.ssd_scan"]
NEVER = "if (acc[0][0] == 12345.f) "     # a store the data never reaches

# (old, new) replacements in the source; each old text occurs once
VARIANTS = {
    "as built (2-stage rings)": [],
    "ssd_state ring of 3": [("constexpr int STATE_STAGES = 2;",
                             "constexpr int STATE_STAGES = 3;")],
    "ssd_out ring of 3": [("constexpr int OUT_STAGES = 2;",
                           "constexpr int OUT_STAGES = 3;")],
    "ablation: ssd_state without its products": [
        ("tile_product<T, true, true>(acc, bs, xs, TILE);", "")],
    "ablation: ssd_state without its H stores": [
        ("store_tile<T>(out, p.Ppd, acc,",
         NEVER + "store_tile<T>(out, p.Ppd, acc,")],
    "ablation: ssd_out without the scores times x": [
        ("scores_times_x(acc, cbs, v, cum_i, bs, j0 - r0);", "")],
    "ablation: ssd_out without C H": [
        ("tile_product<T, false, true>(acc, reinterpret_cast<T*>(base), bs,\n"
         "                                       TILE);", "")],
    "ablation: ssd_out without its y stores": [
        ("  store_tile<T>(p.y + ", "  " + NEVER + "store_tile<T>(p.y + ")],
}


def build() -> dict:
    """{variant: (library path, ptxas lines of ssd_state and ssd_out)}, all
    built in parallel."""
    out_dir = _build.BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "ssd_scan.cu").read_text()
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} occurs {src.count(old)}x")
            src = src.replace(old, new)
        cu = out_dir / f"ssd_scan_{i}.cu"
        cu.write_text(src)
        lib = out_dir / f"ssd_scan_{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        lines, info = log.splitlines(), []
        for i, line in enumerate(lines):
            m = re.search(r"(ssd_state|ssd_out)I(13__nv_bfloat16)EEv", line)
            if "Compiling entry" in line and m:
                stats = " ".join(x.split(":", 1)[-1].strip()
                                 for x in lines[i + 2:i + 4])
                info.append(f"{m.group(1)}: {stats}")
        built[name] = (lib, info)
    return built


def use(lib) -> None:
    """Make the wrapper launch the kernels of ``lib``."""
    cdll = ctypes.CDLL(str(lib))
    _build.load = lambda name: cdll
    SSD._entry.cache_clear()
    SSD.kernel_info.cache_clear()


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_us(fn, reps: int) -> str:
    """Device microseconds a call of each kernel, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {re.search(r"ssd_\w+", e.key).group(0):
             e.self_device_time_total / e.count for e in prof.key_averages()
             if e.self_device_time_total > 0 and "ssd_" in e.key}
    return (" ".join(f"{k} {v:.1f}" for k, v in times.items())
            or "kernels not measured (no device time recorded)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, l, h, p, g, n = 4, 2048, 64, 64, 1, 128
    proj = (torch.randn((b, l, h * p + 2 * g * n), generator=gen,
                        device=dev) * 0.5).bfloat16()
    x, bm, cm = proj.split([h * p, g * n, g * n], dim=-1)
    ops = (x.unflatten(-1, (h, p)),
           (F.softplus(torch.randn((b, l, h), generator=gen, device=dev))
            * 0.1).bfloat16(),
           -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.5),
           bm.unflatten(-1, (g, n)), cm.unflatten(-1, (g, n)),
           torch.full((h,), 0.5, device=dev))
    want = ssd_chunked_ref(*ops).float()
    built = build()
    for name, (lib, info) in built.items():
        use(lib)
        got = ssd_scan(*ops).float()
        err = float((got - want).abs().max() / max(1.0, float(
            want.abs().max())))
        print(f"{name}: max err vs plain {err:.3e}; " + "; ".join(info),
              flush=True)
    for r in range(args.rounds):
        for name, (lib, _) in built.items():
            use(lib)
            t = cuda_ms(lambda: ssd_scan(*ops), 20)
            print(f"round {r}: {name}: {t:.4f} ms a call; "
                  f"{kernel_us(lambda: ssd_scan(*ops), 5)}", flush=True)


if __name__ == "__main__":
    main()
