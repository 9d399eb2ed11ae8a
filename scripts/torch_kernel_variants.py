"""Time variants of the hand-written B1 (block_gemm) and B4 (decode
attention) kernels on the GPU, to see which design choice holds each back.

    PYTHONPATH=src python scripts/torch_kernel_variants.py [--rounds 3]

Needs one CUDA GPU and nvcc. Each variant is a copy of the kernel's source
(``src/repro_torch/kernels/csrc``) with a few constants changed, built with
``nvcc -Xptxas -v`` into ``kernels/_build/variants/`` and loaded in place of
the built library, so the port's own wrapper (its layout choice and split
plan included) launches it. For each variant the script prints the
registers and spill bytes ptxas reports for the f32 SGEMM (B1) or the bf16
tensor-core partials kernel (B4), its largest error against the plain
version at the main path's shape, and its time (CUDA events) in turns with
the one PyTorch call that computes the same function (``torch.bmm``,
``scaled_dot_product_attention``), round after round. Shapes: B1 at the
Cholesky's largest call (``[480,512,512] x .mT``) and the GEMM update
(``[64,1024,1024]`` row-major), f32; B4 at yi-6b's decode layer over a
32 768-position cache (q ``[8,32,128]``, K/V ``[8,4,32768,128]``), bf16.
"""

import argparse
import ctypes
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.block_gemm import block_gemm, block_gemm_ref
from repro_torch.kernels.decode_attention import decode_attention, decode_ref

GEMM = sys.modules["repro_torch.kernels.block_gemm.block_gemm"]
DECODE = sys.modules["repro_torch.kernels.decode_attention.decode_attention"]

# (old, new) replacements in the source; each old text occurs once
B1_VARIANTS = {
    "as built (BK 16, 4 stages, 2 blocks/SM)": [],
    "BK 32, 3 stages": [
        ("constexpr int BK = 16;", "constexpr int BK = 32;"),
        ("constexpr int STAGES = 4;         // K steps",
         "constexpr int STAGES = 3;         // K steps")],
    "no 2-block bound, k groups unrolled (1 block/SM)": [
        ("__launch_bounds__(ring::THREADS, 2)",
         "__launch_bounds__(ring::THREADS)"),
        ("#pragma unroll 1   // one group of KR k", "#pragma unroll   // KR k")],
}
B4_VARIANTS = {
    "as built (8 warps, 128-position tiles, 2 stages)": [],
    "8 warps, 128-position tiles, 3 stages": [
        ("constexpr int STAGES = 2;         // tiles",
         "constexpr int STAGES = 3;         // tiles")],
    "4 warps, 64-position tiles, 3 stages": [
        ("constexpr int THREADS = 256;      // 8 warps",
         "constexpr int THREADS = 128;      // 4 warps"),
        ("constexpr int TS = 128;           // cache positions per tile",
         "constexpr int TS = 64;            // cache positions per tile"),
        ("constexpr int STAGES = 2;         // tiles",
         "constexpr int STAGES = 3;         // tiles")],
    "4 warps, 64-position tiles, 4 stages": [
        ("constexpr int THREADS = 256;      // 8 warps",
         "constexpr int THREADS = 128;      // 4 warps"),
        ("constexpr int TS = 128;           // cache positions per tile",
         "constexpr int TS = 64;            // cache positions per tile"),
        ("constexpr int STAGES = 2;         // tiles",
         "constexpr int STAGES = 4;         // tiles")],
}


def build(source: str, variants: dict, kernel: str) -> dict:
    """{variant: (library path, ptxas line of ``kernel``)}, all built in
    parallel."""
    out_dir = _build.BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / f"{source}.cu").read_text()
    jobs = {}
    for i, (name, subs) in enumerate(variants.items()):
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} occurs {src.count(old)}x")
            src = src.replace(old, new)
        cu = out_dir / f"{source}_{i}.cu"
        cu.write_text(src)
        lib = out_dir / f"{source}_{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        lines = log.splitlines()
        info = []
        for i, line in enumerate(lines):
            if "Compiling entry" in line and kernel in line:
                fn = re.search(rf"{kernel}I\w*?EEv", line).group(0)
                stats = " ".join(x.split(":", 1)[-1].strip()
                                 for x in lines[i + 2:i + 4])
                info.append(f"{fn}: {stats}")
        built[name] = (lib, info)
    return built


def use(lib) -> None:
    """Make the wrappers launch the kernels of ``lib``."""
    cdll = ctypes.CDLL(str(lib))
    _build.load = lambda name: cdll
    for fn in (GEMM._entry, GEMM.kernel_info, DECODE._entry,
               DECODE._ring_entry, DECODE.kernel_info, DECODE._slots):
        fn.cache_clear()


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


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def compare(title, built, cases, rounds, reps):
    print(f"== {title}", flush=True)
    for name, (_, info) in built.items():
        print(f"  {name}: " + "; ".join(info), flush=True)
    for label, kernel, plain, library, work, unit in cases:
        for name, (lib, _) in built.items():
            use(lib)
            print(f"  {label}, {name}: max err vs plain "
                  f"{rel_err(kernel(), plain()):.3e}", flush=True)
        for r in range(rounds):
            t = cuda_ms(library, reps)
            print(f"  {label} round {r}: library {t:.4f} ms "
                  f"({work / t * 1e-9:.1f} {unit})", flush=True)
            for name, (lib, _) in built.items():
                use(lib)
                t = cuda_ms(kernel, reps)
                print(f"  {label} round {r}: {name} {t:.4f} ms "
                      f"({work / t * 1e-9:.1f} {unit})", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    chol = (torch.randn((480, 512, 512), generator=gen, device=dev),
            torch.randn((480, 512, 512), generator=gen, device=dev).mT)
    upd = (torch.randn((64, 1024, 1024), generator=gen, device=dev),
           torch.randn((64, 1024, 1024), generator=gen, device=dev))
    cases = [(f"B1 {lbl}", lambda a=a, b=b: block_gemm(a, b),
              lambda a=a, b=b: block_gemm_ref(a, b),
              lambda a=a, b=b: torch.bmm(a, b),
              2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2],
              "TFLOP/s")
             for lbl, (a, b) in (("[480,512,512] x .mT", chol),
                                 ("[64,1024,1024]", upd))]
    compare("B1 block_gemm f32", build("block_gemm", B1_VARIANTS,
                                       "sgemm_ring"), cases, args.rounds, 5)
    del chol, upd, cases
    torch.cuda.empty_cache()

    b, hq, hkv, s, d = 8, 32, 4, 32768, 128
    q = torch.randn((b, hq, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
    kv_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    mask = torch.ones((b, 1, 1, s), dtype=torch.bool, device=dev)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    cases = [("B4 yi-6b decode layer, 32k cache",
              lambda: decode_attention(q, k, v, kv_len),
              lambda: decode_ref(q, k, v, kv_len),
              lambda: F.scaled_dot_product_attention(
                  q[:, :, None], k, v, attn_mask=mask, enable_gqa=True),
              nbytes * 1e3, "GB/s")]
    compare("B4 decode_attention bf16", build(
        "decode_attention", B4_VARIANTS, "decode_partial_ring"), cases,
        args.rounds, 20)


if __name__ == "__main__":
    main()
