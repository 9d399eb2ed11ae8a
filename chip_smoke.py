#!/usr/bin/env python3
"""Drive the port's main path on one GPU and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA GPU (Hopper,
sm_90a) and the CUDA toolkit. It imports ``repro_torch`` from ``src/`` and
nothing of JAX or of the JAX package ``repro``. Phases:

1. build every kernel of the path from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (into ``src/repro_torch/kernels/_build/``);
2. hold each kernel against its plain version on the card, in f32 and bf16,
   at the reference's test shapes and at the main path's shapes;
3. Cholesky, N = 16384 (32 x 32 blocks of 512, 2 x 2 shards, f32) through
   ``cholesky_executor(..., matmul=task_matmul)``: residual, agreement with
   the same executor on plain bodies, kernel launches, wall time;
4. staged GEMM 2D, N = 8192 (8 x 8 blocks of 1024, 2 x 2 shards) against
   ``torch.matmul`` of the assembled matrices;
5. time each kernel, its plain version and one PyTorch library call at the
   main path's shapes (CUDA events), beside the least time the card could
   take (its bound);
6. print the kernels ported, the card, a JSON line of per-kernel numbers
   and, last, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.block_gemm import (block_gemm,  # noqa: E402
                                            block_gemm_ref, task_matmul)
from repro_torch.linalg.cholesky import (assemble_lower,  # noqa: E402
                                         cholesky_executor, cholesky_program,
                                         make_spd_blocks)
from repro_torch.linalg.gemm import (assemble, gemm_2d_program,  # noqa: E402
                                     gemm_executor)

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W): f32 on the CUDA
# cores, and device memory bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel against plain version, as max|got - want| / max(1, max|want|).
# f32: the reference's own 2e-5 (tests/test_kernels.py); the two differ
# only in the order of f32 sums, ~2^-24 * sqrt(K) relative, 1e-6 at K=1024.
# bf16: 2e-2, the reference's; both sum in f32 and round once to bf16, so
# they differ by at most one bf16 rounding (2^-8 relative).
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# Cholesky N=16384: ||L L^T - A||_F / ||A||_F. A = m m^T / n + 2 I has
# eigenvalues in about [2, 6], so f32 Cholesky's backward error is a few
# u * sqrt(n) = 6e-8 * 128 = 8e-6 at most in practice; 2e-5 leaves room for
# the sums of 32 panels without hiding a wrong block (which gives ~1).
CHOL_RESID_TOL = 2e-5
# max|L_kernel - L_plain|: both are f32 factorizations that differ only in
# the order of the trailing-update sums; with cond(A) <= 3 and |L| <= ~2.5
# the forward difference stays near u * sqrt(n) * cond ~ 3e-5; 1e-3 is a
# ceiling that still catches any wrong block (differences of order 1).
CHOL_PLAIN_TOL = 1e-3
# GEMM N=8192 against torch.matmul, as max|diff| / max|ref|: two f32 sums of
# 8192 products in different orders differ by ~u * sqrt(K) = 5e-6 relative
# to the largest entry; 1e-4 is that with a 20x margin.
GEMM_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events, after
    one warm-up call."""
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


def gemm_bound_ms(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Least time for C = A @ B on the card: each input read once, C written
    once, against the f32 FMA rate of the CUDA cores."""
    T, M, K = a.shape
    N = b.shape[-1]
    nbytes = a.element_size() * T * (M * K + K * N + M * N)
    flops = 2.0 * T * M * N * K
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phases

def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build("block_gemm")
    log(f"[build] nvcc {built or 'nothing to build'}; "
        f"{time.perf_counter() - t0:.2f} s in all")


def gemm_operands(gen, dev, dtype, T, M, K, N, b_transposed=False):
    a = torch.randn((T, M, K), generator=gen, device=dev).to(dtype)
    if b_transposed:   # B = X.mT, a strided view as in the Cholesky bodies
        b = torch.randn((T, N, K), generator=gen, device=dev).to(dtype).mT
    else:
        b = torch.randn((T, K, N), generator=gen, device=dev).to(dtype)
    return a, b


def phase_kernel_vs_plain(dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for m, n, k in ((64, 64, 64), (128, 64, 96), (32, 128, 64),
                    (256, 256, 128)):                 # tests/test_kernels.py
        cases.append((f"{m}x{k}@{k}x{n}", 1, m, k, n, False))
    for bs in (4, 8, 16):                             # executor body form
        cases.append((f"[5,{bs},{bs}]@.mT", 5, bs, bs, bs, True))
    cases += [("[120,512,512]@.mT", 120, 512, 512, 512, True),
              ("[480,512,512]@.mT", 480, 512, 512, 512, True),
              ("[16,1024,1024]", 16, 1024, 1024, 1024, False),
              ("[64,1024,1024]", 64, 1024, 1024, 1024, False)]
    for dtype in (torch.float32, torch.bfloat16):
        for name, T, m, k, n, tr in cases:
            a, b = gemm_operands(gen, dev, dtype, T, m, k, n, tr)
            got, want = block_gemm(a, b), block_gemm_ref(a, b)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dtype,
                  f"block_gemm {name} {dtype}: shape/dtype")
            err = rel_err(got, want)
            log(f"[kernel] block_gemm {name:<20} {str(dtype)[6:]:<9} "
                f"max err {err:.3e} (tol {TOL[dtype]:.0e})")
            check(math.isfinite(err) and err <= TOL[dtype],
                  f"block_gemm {name} {dtype}: err {err} > {TOL[dtype]}")
            if T > 1:   # a task's result does not depend on its batch
                part = block_gemm(a[:3], b[:3])
                check(torch.equal(part, got[:3]),
                      f"block_gemm {name} {dtype}: batch-dependent result")
    log("[kernel] tolerance: max|kernel - plain| / max(1, max|plain|); "
        "f32 2e-5 is the reference's (sums differ only in order, "
        "~2^-24 sqrt(K)); bf16 2e-2 is the reference's (one bf16 rounding "
        "of an f32 sum, 2^-8)")


def phase_cholesky(dev, nb=32, pr=2, pc=2, b=512) -> dict:
    t0 = time.perf_counter()
    prog = cholesky_program(nb, pr, pc, b)
    plan = prog.plan_lowering()
    log(f"[cholesky] N={nb * b} nb={nb} b={b} grid {pr}x{pc}: "
        f"{prog.schedule.n_wavefronts} wavefronts, n_slots {prog.n_slots}, "
        f"plan {plan['mode']}; host build "
        f"{time.perf_counter() - t0:.2f} s")
    blocks, a = make_spd_blocks(nb, b, seed=0, device=dev)
    packed = prog.pack(blocks, device=dev)
    del blocks
    run = cholesky_executor(prog, matmul=task_matmul, device=dev)
    plain = cholesky_executor(prog, device=dev)
    check(run.mode == "segmented_scan", f"executor mode {run.mode}")

    run(packed)                                   # warm-up
    torch.cuda.synchronize()
    block_gemm.launches = 0
    run.calls.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run(packed)
    end.record()
    end.synchronize()
    launches = block_gemm.launches
    batches = run.calls["syrk"] + run.calls["gemm"]
    wall = start.elapsed_time(end)
    log(f"[cholesky] kernel bodies: {wall:.1f} ms; block_gemm launches "
        f"{launches}, executor syrk+gemm batch calls {batches}; body calls "
        f"{dict(run.calls)}, largest batch {dict(run.max_batch)}")
    check(launches > 0 and launches == batches,
          f"block_gemm launches {launches} != syrk+gemm calls {batches}")

    L = assemble_lower(prog.unpack(out), nb, b)
    del out
    check(bool(torch.isfinite(L).all()), "Cholesky: non-finite L")
    resid = float(torch.linalg.vector_norm(torch.matmul(L, L.mT) - a)
                  / torch.linalg.vector_norm(a))
    log(f"[cholesky] ||L L^T - A||_F / ||A||_F = {resid:.3e} "
        f"(limit {CHOL_RESID_TOL:.0e})")
    check(resid <= CHOL_RESID_TOL, f"Cholesky residual {resid}")

    plain_ms = cuda_ms(lambda: plain(packed), 1)
    L_plain = assemble_lower(prog.unpack(plain(packed)), nb, b)
    diff = float((L - L_plain).abs().max())
    log(f"[cholesky] plain bodies: {plain_ms:.1f} ms; max|L_kernel - "
        f"L_plain| = {diff:.3e} (limit {CHOL_PLAIN_TOL:.0e})")
    check(diff <= CHOL_PLAIN_TOL, f"Cholesky kernel vs plain {diff}")
    del L_plain

    # The auto policy keeps the JAX package's plan (union-cover scan, tables
    # padded to each type's largest batch); the unrolled lowering of the same
    # program runs only the real tasks. B1 is bitwise batch-independent;
    # the library's potrf/trsm may not be, hence a tolerance.
    unrolled = cholesky_executor(prog, matmul=task_matmul, device=dev,
                                 unroll_cap=prog.schedule.n_wavefronts)
    unrolled_ms = cuda_ms(lambda: unrolled(packed), 1)
    L_unrolled = assemble_lower(prog.unpack(unrolled(packed)), nb, b)
    diff = float((L - L_unrolled).abs().max())
    log(f"[cholesky] unrolled lowering, kernel bodies: {unrolled_ms:.1f} ms; "
        f"max|L_scan - L_unrolled| = {diff:.3e} (limit {CHOL_PLAIN_TOL:.0e})")
    check(diff <= CHOL_PLAIN_TOL, f"Cholesky scan vs unrolled {diff}")
    return {"launches": launches, "max_batch": run.max_batch["gemm"]}


def phase_gemm(dev, nb=8, pr=2, pc=2, b=1024) -> dict:
    n = nb * b
    prog = gemm_2d_program(nb, pr, pc, b, staged=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    A = torch.randn((n, n), generator=gen, device=dev)
    B = torch.randn((n, n), generator=gen, device=dev)
    blocks = {}
    for i in range(nb):
        for j in range(nb):
            blocks[("A", i, j)] = A[i * b:(i + 1) * b, j * b:(j + 1) * b]
            blocks[("B", i, j)] = B[i * b:(i + 1) * b, j * b:(j + 1) * b]
            blocks[("C", i, j)] = torch.zeros((b, b), device=dev)
    packed = prog.pack(blocks, device=dev)
    del blocks
    run = gemm_executor(prog, matmul=task_matmul, device=dev)
    run(packed)                                   # warm-up
    torch.cuda.synchronize()
    block_gemm.launches = 0
    run.calls.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run(packed)
    end.record()
    end.synchronize()
    launches = block_gemm.launches
    log(f"[gemm] N={n} staged, {prog.schedule.n_wavefronts} wavefronts, "
        f"mode {run.mode}: {start.elapsed_time(end):.1f} ms; block_gemm "
        f"launches {launches}, executor gemm batch calls "
        f"{run.calls['gemm']}, largest batch {run.max_batch['gemm']}")
    check(launches > 0 and launches == run.calls["gemm"],
          f"GEMM: launches {launches} != gemm calls {run.calls['gemm']}")
    C = assemble(prog.unpack(out), "C", nb, b)
    ref = torch.matmul(A, B)
    check(bool(torch.isfinite(C).all()), "GEMM: non-finite C")
    err = float((C - ref).abs().max() / ref.abs().max())
    log(f"[gemm] max|C - A@B| / max|A@B| = {err:.3e} (limit {GEMM_TOL:.0e})")
    check(err <= GEMM_TOL, f"GEMM error {err}")
    return {"launches": launches, "max_batch": run.max_batch["gemm"]}


def phase_yardstick(dev, chol_batch: int, gemm_batch: int, b_chol=512,
                    b_gemm=1024) -> dict:
    """Times at the main path's largest body calls (the Cholesky gemm
    update over ``chol_batch`` tasks, the GEMM update over ``gemm_batch``)
    and at one shard's share of each."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {}
    bc, bg = b_chol, b_gemm
    for name, T, m, k, n, tr in (
            ("cholesky gemm", chol_batch, bc, bc, bc, True),
            ("cholesky gemm, one shard", max(1, chol_batch // 4),
             bc, bc, bc, True),
            ("gemm update", gemm_batch, bg, bg, bg, False),
            ("gemm update, one shard", max(1, gemm_batch // 4),
             bg, bg, bg, False)):
        a, b = gemm_operands(gen, dev, torch.float32, T, m, k, n, tr)
        got = block_gemm(a, b)
        err = float((got - block_gemm_ref(a, b)).abs().max())
        reps = 5
        kernel = cuda_ms(lambda: block_gemm(a, b), reps)
        plain = cuda_ms(lambda: block_gemm_ref(a, b), reps)
        library = cuda_ms(lambda: torch.bmm(a, b), reps)
        kernel2 = cuda_ms(lambda: block_gemm(a, b), reps)
        bound, bound_by = gemm_bound_ms(a, b)
        label = f"{name} [{T},{m},{k}]x[{T},{k},{n}]"
        log(f"[time] block_gemm {label}: kernel {kernel:.3f} / {kernel2:.3f} "
            f"ms, plain {plain:.3f} ms, torch.bmm {library:.3f} ms, bound "
            f"{bound:.3f} ms ({bound_by}); {2e-9 * T * m * n * k / kernel:.1f} "
            f"TFLOP/s")
        rows[name] = {"ms": min(kernel, kernel2), "plain_ms": plain,
                      "library_ms": library, "bound_ms": bound,
                      "bound_by": bound_by, "max_abs_err": err,
                      "shape": [T, m, k, n]}
        del a, b, got
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 means IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    phase_kernel_vs_plain(dev)
    chol = phase_cholesky(dev)
    torch.cuda.empty_cache()
    gemm = phase_gemm(dev)
    torch.cuda.empty_cache()
    times = phase_yardstick(dev, chol["max_batch"], gemm["max_batch"])
    main_row = times["cholesky gemm"]
    log(f"[done] {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; GEMM main "
        f"path launches {gemm['launches']}")
    log("kernels: block_gemm")
    log(card())
    log(json.dumps({"kernels": [{
        "name": "block_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_gemm.cu",
        "replaces": "src/repro/kernels/block_gemm/block_gemm.py:40",
        "launches": chol["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
