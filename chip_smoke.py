#!/usr/bin/env python3
"""Drive the port's main path on one GPU and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA GPU (Hopper,
sm_90a) and the CUDA toolkit. It imports ``repro_torch`` from ``src/`` and
nothing of JAX or of the JAX package ``repro``. Phases:

1. build every kernel of the paths from ``src/repro_torch/kernels/csrc``
   with ``nvcc``, one compiler per source, all started together (into
   ``src/repro_torch/kernels/_build/``), and check in the SASS that B2's
   bf16 instantiations run on the tensor cores (HGMMA) and B3's and B4's
   bf16 kernels do (HMMA), while B2's, B3's and B4's f32 kernels and B1's
   f32 SGEMM use neither (IEEE f32 on the CUDA cores);
2. hold each kernel against its plain version on the card, in f32 and bf16,
   at the reference's test shapes and at the main paths' shapes: B1
   block_gemm (each of its four layout instantiations at ragged M, N and
   K too, every batched case bit for bit against its tasks alone), B2
   flash_attention (with yi-6b's prefill head layout and
   the model's own strided prefill call, ragged L, D 64 and 48, the chain
   task; per (batch, q head) too; no operand copied; a chain task's result
   independent of its batch), B3 ssd_scan (with mamba2-1.3b's layer at
   prefill, in its own strided layout, and chunks of 256 and 512 at
   d_state 128; per (batch, head) too; no element-wise copies of the
   model's layout; a head's result independent of its batch) and B4
   decode_attention (with yi-6b's decode layer over a
   32 768-position cache, and ranges of several tiles that end one short
   of and one past a tile and a ring stage; no bf16 call of the model's
   layout on the CUDA-core kernel); each kernel's registers, spills and
   resident blocks per SM;
3. Cholesky, N = 16384 (32 x 32 blocks of 512, 2 x 2 shards, f32) through
   ``cholesky_executor(..., matmul=task_matmul)``: residual, agreement with
   the same executor on plain bodies, kernel launches, wall time; then the
   same matrix on the host TaskTorrent runtime (``Graph.run_host`` on
   ``inproc``: 4 ranks x 2 worker threads, block stores on the card, B1 on
   each syrk/gemm task, ``torch.linalg`` on potrf/trsm, active messages
   carrying blocks as on-device copies): residual, agreement with the
   compiled factor, exactly one B1 launch per syrk/gemm task, no tensor
   pickled; wall time, tasks/s, AMs and bytes per rank pair, the device's
   idle share under the profiler, and the runtime's own cost per task
   (bodies that return their first operand); and a Cholesky of 8 x 8
   blocks of 512 under message loss, duplication and a rank killed mid-run,
   bit for bit the fault-free run on the card;
4. staged GEMM 2D, N = 8192 (8 x 8 blocks of 1024, 2 x 2 shards) against
   ``torch.matmul`` of the assembled matrices;
5. the attention-chain PTG, seq 4096, dim 128, depth 16, 2 shards, f32,
   through ``auto_executor`` with ``task_attention`` bodies, against the
   same program on ``mha_ref`` bodies; B2 launches = executor attn calls;
   one profiled run; the unrolled, dense-scan and union-cover lowerings
   bit for bit;
6. mamba2-1.3b serving at full width (48 layers, d_model 2048, f32 weights
   from a seeded generator, bf16 compute): ``make_prefill_step`` on 4
   prompts of 2048 tokens (48 B3 launches) against the same step with the
   plain SSD (no B3 call on its element-wise copies); 16 greedy
   ``make_serve_step`` tokens from a fresh cache; and prefill logits of a
   256-token prompt against 256 ``decode_step``s;
7. yi-6b serving at full width (32 layers, d_model 4096, GQA 32 over 4 KV
   heads of 128, f32 weights from a seeded generator, bf16 compute):
   prefill of 4 prompts of 2048 tokens (32 B2 launches, no operand
   copied) against the same step with the plain attention; 16 greedy
   tokens at batch 8 from a fresh cache, and 16 at batch 8 over a 32
   768-position cache filled to 32 752
   (32 B4 launches a step); gates in f32 compute (prefill kernel vs plain,
   prefill(256) vs 256 decode steps, one long-cache decode step with B4 vs
   ``decode_ref``);
8. time each kernel, its plain version and one PyTorch library call at the
   main paths' shapes (CUDA events), beside the least time the card could
   take (its bound);
9. print the kernels ported, the card, a JSON line of per-kernel numbers
   and, last, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.block_gemm import (block_gemm,  # noqa: E402
                                            block_gemm_ref, task_matmul)
from repro_torch.kernels.block_gemm.block_gemm import (  # noqa: E402
    kernel_info as gemm_kernel_info)
from repro_torch.kernels.block_gemm.ops import matmul  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_ref, kernel_info as decode_kernel_info)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, mha_ref, task_attention)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    kernel_info as attention_kernel_info)
from repro_torch.kernels.ssd_scan import (ssd_chunked_ref,  # noqa: E402
                                          ssd_ref, ssd_scan)
from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: E402
    kernel_info as ssd_kernel_info, plan as ssd_plan)
from repro_torch.core import FaultPlan, payload_stats  # noqa: E402
from repro_torch.linalg.cholesky import (assemble_lower,  # noqa: E402
                                         cholesky_bodies, cholesky_executor,
                                         cholesky_graph, cholesky_program,
                                         make_spd_blocks)
from repro_torch.linalg.host_exec import run_host_ptg  # noqa: E402
from repro_torch.linalg.gemm import (assemble, gemm_2d_program,  # noqa: E402
                                     gemm_executor)
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.ptg import Graph  # noqa: E402
from repro_torch.serve.decode import (make_prefill_step,  # noqa: E402
                                      make_serve_step)

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W): f32 on the
# CUDA cores, bf16 on the tensor cores, and device memory bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel against plain version, as max|got - want| / max(1, max|want|).
# f32: the reference's own 2e-5 (tests/test_kernels.py); the two differ
# only in the order of f32 sums, ~2^-24 * sqrt(K) relative, 1e-6 at K=1024.
# bf16: 2e-2, the reference's; both sum in f32 and round once to bf16, so
# they differ by at most one bf16 rounding (2^-8 relative).
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The attention chain, kernel bodies against mha_ref bodies over all 16
# tasks, same measure. Task l attends over its own input (q = k = v), so
# each task maps the previous task's rounding difference through a sharp
# softmax (self-logits ~|x|^2 / sqrt(D)); on the card each task adds ~3e-7
# and the chain grows it by ~1.4x per task (9.6e-5 after 16). 1e-3 holds
# that with a 10x margin; each task alone is held to TOL (per-task check).
CHAIN_TOL = 1e-3
# B3 against ssd_chunked_ref, same measure. f32: the reference's 2e-4 (the
# two take exp of cumulative sums and sum the chunk products in other
# orders). bf16: both read the same bf16 operands and round y once; the
# kernel also rounds its tensor-core operands (the scores, x ⊙ dt ⊙
# exp(cum_Q − cum), the states entering each chunk) to bf16: 2e-2, the
# reference's.
TOL_SSD = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# B3 is also held per (batch, head), normalised by that head's own
# max|plain| over its [L, P]. Measured on the CPU by
# scripts/torch_ssd_rounding.py at mamba2-1.3b's layer (Q 128 and 256): the
# kernel's arithmetic (ssd_bf16_operands_ref) moves a head by up to 5.7e-7
# of its size in f32 (sums in another order; 1e-4, as B4's, is ~175x that)
# and 7.3e-3 in bf16 (about one bf16 rounding of y near the head's max;
# 2e-2 is the reference's bf16 tolerance).
SSD_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

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


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over the leading axes of max|got - want| / max|want| within
    the last axis: each row is held to its own size, with no floor."""
    got, want = got.float(), want.float()
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


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
    return bound(nbytes, 2.0 * T * M * N * K, torch.float32)


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> tuple:
    """Least time on the card: the bytes moved (each input read once, each
    output written once) over the memory rate, or the operations over the
    peak rate for the operands' type, whichever is larger."""
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def attention_work(q, k, causal=True) -> tuple:
    """B2's (bytes, FLOPs): q, k, v read and o written once; 4·D FLOPs (q·k
    and p·v) per (query, key) pair the mask keeps, as this call's shapes
    give."""
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    if causal:   # queries are the last lq of lk: query i sees lk - lq + i + 1
        pairs = sum(min(lk, lk - lq + i + 1) for i in range(lq))
    else:
        pairs = lq * lk
    return (q.element_size() * (2 * q.numel() + 2 * k.numel()),
            4.0 * d * pairs * b * hq)


def ssd_work(x, b, q_chunk) -> tuple:
    """B3's (bytes, FLOPs): x, dt, B, C read and y written once; per chunk
    of qv rows, the causal half of C Bᵀ once per (batch, group) (qv(qv+1)/2
    pairs x N x 2), and per (batch, head) the causal half of its product
    with dt·x (qv(qv+1)/2 x P x 2) plus C h and Bᵀ (dt·x) (4 qv N P), as
    this call's shapes give."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    per_group = per_head = 0.0
    for t0 in range(0, l, q_chunk):
        qv = min(q_chunk, l - t0)
        per_group += qv * (qv + 1) * n
        per_head += qv * (qv + 1) * p + 4.0 * qv * n * p
    return (x.element_size() * (2 * x.numel() + bsz * l * h
                                + 2 * bsz * l * g * n),
            per_group * bsz * g + per_head * bsz * h)


def leaves(tree):
    """The tensors of a nested dict."""
    for v in tree.values():
        yield from (leaves(v) if isinstance(v, dict) else (v,))


def reset_launches() -> None:
    """Zero every kernel's launch counter, B2's count of operands copied
    for TMA, B3's count of calls with element-wise copies and B4's count of
    bf16 calls on its CUDA-core kernel, just before a main-path run."""
    for kernel in (block_gemm, flash_attention, ssd_scan, decode_attention):
        kernel.launches = 0
    flash_attention.copies = 0
    ssd_scan.narrow = 0
    decode_attention.narrow = 0


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phases

def sass_counts(name: str, opcodes) -> dict:
    """{kernel function: {opcode: count}} of ``csrc/<name>.cu``'s built
    library, from ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn is not None:
            for op in opcodes:
                counts[fn][op] += f" {op}." in line or f" {op} " in line
    return counts


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build("block_gemm", "flash_attention", "ssd_scan",
                         "decode_attention")
    log(f"[build] nvcc {built or 'nothing to build'}; "
        f"{time.perf_counter() - t0:.2f} s in all")
    # B2's bf16 path must run on the tensor cores (wgmma is HGMMA in SASS)
    # and its f32 path on the CUDA cores (no HGMMA, no HMMA: no TF32)
    counts = sass_counts("flash_attention", ("HGMMA", "HMMA"))
    bf16 = {f: c for f, c in counts.items() if "4bf169fa_kernel" in f}
    f32 = {f: c for f, c in counts.items()
           if "partial_kernel" in f or "merge_kernel" in f}
    log(f"[build] flash_attention SASS: bf16 kernels "
        f"{[c['HGMMA'] for c in bf16.values()]} HGMMA; f32 kernels "
        f"{[c['HGMMA'] + c['HMMA'] for c in f32.values()]} HGMMA+HMMA")
    check(len(bf16) == 2 and all(c["HGMMA"] > 0 for c in bf16.values()),
          f"flash_attention bf16 instantiations without HGMMA: {bf16}")
    check(len(f32) >= 5 and not any(c["HGMMA"] or c["HMMA"]
                                    for c in f32.values()),
          f"flash_attention f32 kernels on the tensor cores: {f32}")
    # B4's bf16 ring kernel runs Q·Kᵀ and P·V on mma.sync (HMMA); its f32
    # partials and merge kernels stay on the CUDA cores
    counts = sass_counts("decode_attention", ("HGMMA", "HMMA"))
    ring = {f: c for f, c in counts.items() if "decode_partial_ring" in f}
    f32 = {f: c for f, c in counts.items()
           if "decode_partialIf" in f or "decode_combineIf" in f}
    log(f"[build] decode_attention SASS: bf16 ring kernels "
        f"{[c['HMMA'] for c in ring.values()]} HMMA; f32 kernels "
        f"{[c['HGMMA'] + c['HMMA'] for c in f32.values()]} HGMMA+HMMA")
    check(len(ring) == 2 and all(c["HMMA"] > 0 for c in ring.values()),
          f"decode_attention bf16 ring kernels without HMMA: {ring}")
    check(len(f32) >= 7 and not any(c["HGMMA"] or c["HMMA"]
                                    for c in f32.values()),
          f"decode_attention f32 kernels on the tensor cores: {f32}")
    # B1's f32 SGEMM (all four layouts) stays IEEE f32 on the CUDA cores
    counts = sass_counts("block_gemm", ("HGMMA", "HMMA", "FFMA"))
    f32 = {f: c for f, c in counts.items() if "sgemm_ring" in f}
    log(f"[build] block_gemm SASS: f32 kernels "
        f"{[c['HGMMA'] + c['HMMA'] for c in f32.values()]} HGMMA+HMMA, "
        f"{[c['FFMA'] for c in f32.values()]} FFMA")
    check(len(f32) == 4 and all(c["FFMA"] > 0 and not c["HGMMA"]
                                and not c["HMMA"] for c in f32.values()),
          f"block_gemm f32 kernels on the tensor cores: {f32}")
    # B3's bf16 products (C Bᵀ, the chunk states, C H and the scores times
    # x) run on mma.sync (HMMA); its f32 kernels stay on the CUDA cores
    counts = sass_counts("ssd_scan", ("HGMMA", "HMMA", "FFMA"))
    bf16 = {f: c for f, c in counts.items()
            if "nv_bfloat16" in f and "ssd_cumsum" not in f}
    f32 = {f: c for f, c in counts.items() if "nv_bfloat16" not in f}
    log(f"[build] ssd_scan SASS: bf16 kernels "
        f"{[c['HMMA'] for c in bf16.values()]} HMMA; f32 kernels "
        f"{[c['HGMMA'] + c['HMMA'] for c in f32.values()]} HGMMA+HMMA, "
        f"{[c['FFMA'] for c in f32.values()]} FFMA")
    check(len(bf16) == 3 and all(c["HMMA"] > 0 for c in bf16.values()),
          f"ssd_scan bf16 kernels without HMMA: {bf16}")
    check(len(f32) == 4 and not any(c["HGMMA"] or c["HMMA"]
                                    for c in f32.values()),
          f"ssd_scan f32 kernels on the tensor cores: {f32}")
    for dtype in (torch.float32, torch.bfloat16):
        for name, info in ssd_kernel_info(dtype, 0).items():
            log(f"[build] ssd_scan {str(dtype)[6:]} {name}: "
                f"{info.registers} registers, {info.spill_bytes} spill "
                f"bytes per thread, {info.blocks_per_sm} resident blocks "
                f"per SM, {info.smem_bytes} B shared (CUDA runtime)")
            check(info.spill_bytes == 0 and info.blocks_per_sm >= 1,
                  f"ssd_scan {dtype} {name}: {info}")


def gemm_operands(gen, dev, dtype, T, M, K, N, a_k=True, b_n=True):
    """A [T, M, K] k- (else m-) contiguous, B [T, K, N] n- (else k-)
    contiguous (B = X.mT, a strided view as in the Cholesky bodies): one
    of B1's four f32 instantiations."""
    a = (torch.randn((T, M, K), generator=gen, device=dev) if a_k else
         torch.randn((T, K, M), generator=gen, device=dev).mT).to(dtype)
    b = (torch.randn((T, K, N), generator=gen, device=dev) if b_n else
         torch.randn((T, N, K), generator=gen, device=dev).mT).to(dtype)
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
            a, b = gemm_operands(gen, dev, dtype, T, m, k, n, b_n=not tr)
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
    # each layout instantiation at ragged M, N and K (K not a multiple of
    # the K step), every task of the batch bit for bit as launched alone
    for dtype in (torch.float32, torch.bfloat16):
        for a_k in (True, False):
            for b_n in (True, False):
                for T, m, k, n in ((3, 130, 70, 129), (4, 131, 37, 67),
                                   (2, 257, 300, 129)):
                    a, b = gemm_operands(gen, dev, dtype, T, m, k, n, a_k,
                                         b_n)
                    got, want = block_gemm(a, b), block_gemm_ref(a, b)
                    err = rel_err(got, want)
                    alone = all(torch.equal(block_gemm(a[i:i + 1],
                                                       b[i:i + 1])[0], got[i])
                                for i in range(T))
                    name = (f"[{T},{m},{k},{n}] A {'k' if a_k else 'm'}-"
                            f"contiguous B {'n' if b_n else 'k'}-contiguous")
                    log(f"[kernel] block_gemm {name:<42} {str(dtype)[6:]:<9}"
                        f" max err {err:.3e} (tol {TOL[dtype]:.0e}); tasks "
                        f"as alone: {alone}")
                    check(math.isfinite(err) and err <= TOL[dtype],
                          f"block_gemm {name} {dtype}: err {err}")
                    check(alone, f"block_gemm {name} {dtype}: "
                                 "batch-dependent result")
    log("[kernel] tolerance: max|kernel - plain| / max(1, max|plain|); "
        "f32 2e-5 is the reference's (sums differ only in order, "
        "~2^-24 sqrt(K)); bf16 2e-2 is the reference's (one bf16 rounding "
        "of an f32 sum, 2^-8)")
    for a_k, b_n, path in ((True, False, "Cholesky's l @ l.mT"),
                           (True, True, "the GEMM update"),
                           (False, True, "A m-contiguous"),
                           (False, False, "A m-, B k-contiguous")):
        info = gemm_kernel_info(a_k, b_n, dev.index or 0)
        log(f"[kernel] block_gemm f32, {path}: {info.blocks_per_sm} "
            f"resident blocks per SM, {info.registers} registers and "
            f"{info.spill_bytes} spill bytes per thread, {info.smem_bytes} B "
            f"shared, BK {info.bk} x {info.stages} stages (CUDA runtime)")


def head_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over (batch, q head) of max|got - want| / max|want| within
    that head's [L, D]: each head held to its own size, with no floor."""
    return row_err(got.flatten(2), want.flatten(2))


def attention_operands(gen, dev, dtype, b, hq, hkv, lq, lk, d, model=False):
    """q [b, hq, lq, d], k and v [b, hkv, lk, d]; with ``model`` laid out
    as the dense model hands them to B2 (``transformer.py``: [B, S, H, D]
    projections viewed as [B, H, S, D], v never made contiguous)."""
    def make(h, l):
        if model:
            return torch.randn((b, l, h, d), generator=gen,
                               device=dev).to(dtype).transpose(1, 2)
        return torch.randn((b, h, l, d), generator=gen, device=dev).to(dtype)
    return make(hq, lq), make(hkv, lk), make(hkv, lk)


def phase_attention_vs_plain(dev) -> None:
    """B2 against ``mha_ref`` at the reference's test shapes
    (``tests/test_kernels.py:50-77`` and the task form of ``:96-109``), at
    yi-6b's head layout (Hq 32, Hkv 4, D 128) at B 1, L 4096 and in the
    model's own layout at prefill (B 4, L 2048, strided views), at ragged
    L, at D 64 and 48, and at the attention chain's task [1, 1, 4096,
    128]; whole tensor and per (batch, q head). None needs a copy for TMA.
    Then the chain task's batch independence, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(3)
    yi = get_config("yi-6b")
    hq, hkv, hd = yi.n_heads, yi.n_kv_heads, yi.head_dim
    cases = [(f"[{b},{h}|{g},{lq}|{lk},{d}]", (b, h, g, lq, lk, d), False)
             for b, h, g, lq, lk, d in ((1, 4, 4, 128, 128, 64),
                                        (2, 8, 2, 128, 128, 64),
                                        (1, 4, 1, 64, 256, 32),
                                        (1, 2, 2, 256, 256, 128),
                                        (1, 2, 2, 512, 512, 64),
                                        (3, 1, 1, 32, 32, 16),
                                        (1, 2, 2, 1000, 1000, 128),
                                        (1, 2, 2, 1000, 3000, 128),
                                        (2, 8, 2, 777, 777, 64),
                                        (2, 8, 2, 300, 300, 48),
                                        (1, 1, 1, 4096, 4096, 128))]
    cases += [(f"yi-6b [1,{hq}|{hkv},4096,{hd}]", (1, hq, hkv, 4096, 4096, hd),
               False),
              (f"yi-6b model layout [4,{hq}|{hkv},2048,{hd}]",
               (4, hq, hkv, 2048, 2048, hd), True)]
    flash_attention.copies = 0
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, model in cases:
            q, k, v = attention_operands(gen, dev, dtype, *shape, model=model)
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal)
                want = mha_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == dtype,
                      f"flash_attention {name}: shape/dtype")
                err, head = rel_err(got, want), head_err(got, want)
                log(f"[kernel] flash_attention {name:<38} "
                    f"{'causal' if causal else 'full':<6} "
                    f"{str(dtype)[6:]:<9} max err {err:.3e}, per head "
                    f"{head:.3e} (tol {TOL[dtype]:.0e})")
                check(math.isfinite(err) and err <= TOL[dtype],
                      f"flash_attention {name} {dtype}: err {err}")
                check(math.isfinite(head) and head <= TOL[dtype],
                      f"flash_attention {name} {dtype}: per-head err {head}")
                del got, want
            del q, k, v
    log(f"[kernel] flash_attention operands copied for TMA: "
        f"{flash_attention.copies}")
    check(flash_attention.copies == 0, "flash_attention copied operands")
    log("[kernel] flash_attention tolerance: as block_gemm's (the "
        "reference's 2e-5 / 2e-2; f32 sums, the online softmax's rescaling "
        "and the split ranges' merge in another order; bf16: P rounded to "
        "bf16 before P·V and one bf16 rounding of an f32 result), on the "
        "whole tensor and per (batch, q head) against the head's own "
        "max|plain| (scripts/torch_attention_rounding.py)")
    x = torch.randn((3, 4096, 128), generator=gen, device=dev)
    for causal in (True, False):
        batched = task_attention(x, x, x, causal=causal)
        alone = [task_attention(x[t:t + 1], x[t:t + 1], x[t:t + 1],
                                causal=causal) for t in range(3)]
        check(torch.equal(batched, torch.cat(alone)),
              "task_attention: a task's result depends on its batch")
    log("[kernel] task_attention [3,4096,128] f32: each task bit for bit "
        "as alone (causal and full)")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            info = attention_kernel_info(dtype, d, dev.index or 0)
            log(f"[kernel] flash_attention {str(dtype)[6:]} D<={d}: "
                f"{info.blocks_per_sm} resident blocks per SM, "
                f"{info.registers} registers and {info.spill_bytes} spill "
                f"bytes per thread, {info.smem_bytes} B shared, tiles "
                f"{info.bq} queries x {info.bk} keys (CUDA runtime)")


def ssd_operands(gen, dev, dtype, b, l, h, g, p, n, model=False):
    """x, dt, A, B, C, D as ``tests/test_kernels.py`` makes them; with
    ``model``, x, B and C are views of one [b, l, h·p + 2·g·n] projection,
    as ``mamba2_forward`` hands them to B3."""
    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)
    if model:
        proj = (randn(b, l, h * p + 2 * g * n) * 0.5).to(dtype)
        proj[..., :h * p] *= 2.0
        x, bm, cm = proj.split([h * p, g * n, g * n], dim=-1)
        x, bm, cm = (x.unflatten(-1, (h, p)), bm.unflatten(-1, (g, n)),
                     cm.unflatten(-1, (g, n)))
    else:
        x = randn(b, l, h, p).to(dtype)
        bm = (randn(b, l, g, n) * 0.5).to(dtype)
        cm = (randn(b, l, g, n) * 0.5).to(dtype)
    return (x, (F.softplus(randn(b, l, h)) * 0.1).to(dtype),
            -torch.exp(randn(h) * 0.5), bm, cm,
            torch.full((h,), 0.5, device=dev))


def ssd_head_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over (batch, head) of max|got - want| / max|want| within
    that head's [L, P]."""
    return row_err(got.transpose(1, 2).flatten(2),
                   want.transpose(1, 2).flatten(2))


def phase_ssd_vs_plain(dev) -> None:
    """B3 against ``ssd_chunked_ref`` at the reference's test shapes
    (``tests/test_kernels.py:145-181``, the carry test at Q = 32 and 128
    included), at chunks of 256 and 512 with d_state 128 (fault C1), at
    mamba2-1.3b's layer at prefill in its own strided layout (no element-
    wise copies), whole tensor and per (batch, head); then a head's result
    independent of its batch, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(4)
    m = get_config("mamba2-1.3b")
    nh = m.ssm.n_heads(m.d_model)
    layer = (4, 2048, nh, m.ssm.n_groups, m.ssm.head_dim, m.ssm.d_state)
    cases = [((1, 128, 2, 1, 32, 16), 64, False),
             ((2, 256, 4, 2, 64, 32), 128, False),
             ((1, 64, 8, 8, 16, 16), 32, False),
             ((1, 256, 2, 1, 16, 8), 32, False),
             ((1, 256, 2, 1, 16, 8), 128, False),
             ((2, 1024, 4, 1, 64, 128), 256, False),    # C1
             ((1, 1024, 4, 2, 64, 128), 512, False),    # C1
             ((1, 1000, 4, 1, 64, 128), 256, False),    # C1, ragged
             (layer, 128, True), (layer, 256, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, q, model in cases:
            ops = ssd_operands(gen, dev, dtype, *shape, model=model)
            ssd_scan.narrow = 0
            got = ssd_scan(*ops, q_chunk=q)
            torch.cuda.synchronize()
            narrow = ssd_scan.narrow
            want = (ssd_chunked_ref(*ops, q_chunk=q) if shape[1] % q == 0
                    else ssd_ref(*ops))
            b, l, h, g, p, n = shape
            name = (f"x[{b},{l},{h},{p}] b/c[..,{g},{n}] Q{q}"
                    + (" model layout" if model else ""))
            check(got.shape == want.shape and got.dtype == dtype,
                  f"ssd_scan {name}: shape/dtype")
            err, head = rel_err(got, want), ssd_head_err(got, want)
            log(f"[kernel] ssd_scan {name:<48} {str(dtype)[6:]:<9} max err "
                f"{err:.3e} (tol {TOL_SSD[dtype]:.0e}), per head {head:.3e} "
                f"(tol {SSD_ROW_TOL[dtype]:.0e}); "
                f"{ssd_plan(b, l, h, g, p, n, q, got.element_size()).kernels}"
                f" kernels")
            check(math.isfinite(err) and err <= TOL_SSD[dtype],
                  f"ssd_scan {name} {dtype}: err {err}")
            check(math.isfinite(head) and head <= SSD_ROW_TOL[dtype],
                  f"ssd_scan {name} {dtype}: per-head err {head}")
            if model:
                check(narrow == 0, f"ssd_scan {name}: element-wise copies")
            del ops, got, want
    log("[kernel] ssd_scan tolerance: max|kernel - plain| / max(1, "
        "max|plain|); f32 2e-4 is the reference's (exp of cumulative sums, "
        "chunk products in another order); bf16 2e-2, the reference's (the "
        "scores, x·dt·exp(cum_Q - cum) and the chunk states rounded to bf16 "
        "as tensor-core operands, y once); per (batch, head) against the "
        "head's own max|plain|, 1e-4 / 2e-2 (scripts/torch_ssd_rounding.py)")
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, a, bm, cm, d = ssd_operands(gen, dev, dtype, 3, 512, 4, 2, 64,
                                           128)
        batched = ssd_scan(x, dt, a, bm, cm, d)
        alone = [ssd_scan(x[i:i + 1], dt[i:i + 1], a, bm[i:i + 1],
                          cm[i:i + 1], d) for i in range(3)]
        check(torch.equal(batched, torch.cat(alone)),
              f"ssd_scan {dtype}: a head's result depends on its batch")
    log("[kernel] ssd_scan x[3,512,4,64] f32 and bf16: each batch row bit "
        "for bit as alone")


def decode_operands(gen, dev, dtype, b, hq, hkv, s, d):
    return (torch.randn((b, hq, d), generator=gen, device=dev).to(dtype),
            torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype),
            torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype))


# yi-6b's decode layer over the long cache: batch 8 (decode_32k's 128 cut
# for one card), 32 q heads over 4 KV heads of 128, 32 768 positions, and
# ragged lengths from full to one.
DECODE_CELL = (8, 32, 4, 32768, 128)
DECODE_CELL_LEN = (32768, 32751, 17000, 1, 4096, 65, 64, 30000)
# B4 is also held to a tolerance per (batch, q head) row, normalised by that
# row's own max|plain|: a row over 32k positions averages values of either
# sign to ~0.02, a row of kv_len 1 is v[0] (~3), so one scale for the whole
# output would let a long row be wrong by more than its size. Measured on
# the CPU by scripts/torch_decode_rounding.py at this layer: split-cache f32
# partials merged as B4 merges them differ from decode_ref by up to 7.4e-6
# of a row in f32 (1e-4 is ~14x that) and 3.3e-3 in bf16 (one bf16
# rounding of the result; 2e-2 is the reference's bf16 tolerance).
DECODE_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def phase_decode_vs_plain(dev) -> None:
    """B4 against ``decode_ref`` at the reference's test shapes
    (``tests/test_kernels.py:114-140``, its ragged lengths included), a
    ragged S, a cache with replicated KV heads (``kv_head_pad`` 2) and
    yi-6b's decode layer over a 32 768-position cache, f32 and bf16."""
    gen = torch.Generator(device=dev).manual_seed(12)
    cases = [((2, 8, 2, 256, 64), None), ((1, 4, 4, 512, 128), None),
             ((4, 16, 1, 128, 64), None), ((3, 4, 2, 256, 64), (256, 100, 17)),
             ((2, 8, 2, 200, 64), (200, 77)),
             ((2, 8, 4, 333, 128), (333, 45)),      # 2 KV heads, pad 2
             # ranges of 1024 positions (8 tiles of 128, four turns of the
             # ring); ends one short of and one past a tile and a turn
             ((8, 32, 4, 4096, 128), (63, 65, 127, 129, 255, 257, 1151,
                                      1281)),
             (DECODE_CELL, DECODE_CELL_LEN)]
    decode_attention.narrow = 0
    for dtype in (torch.float32, torch.bfloat16):
        for (b, hq, hkv, s, d), lens in cases:
            q, k, v = decode_operands(gen, dev, dtype, b, hq, hkv, s, d)
            if hkv == 4 and hq == 8:                 # replicated heads
                k, v = (t[:, ::2].repeat_interleave(2, dim=1) for t in (k, v))
            kv_len = (None if lens is None else
                      torch.tensor(lens, dtype=torch.int32, device=dev))
            got = decode_attention(q, k, v, kv_len)
            want = decode_ref(q, k, v, kv_len)
            torch.cuda.synchronize()
            name = f"q[{b},{hq},{d}] kv[{b},{hkv},{s},{d}]" + (
                "" if lens is None else f" kv_len{list(lens)[:4]}")
            check(got.shape == want.shape and got.dtype == dtype,
                  f"decode_attention {name}: shape/dtype")
            err, row = rel_err(got, want), row_err(got, want)
            log(f"[kernel] decode_attention {name:<58} {str(dtype)[6:]:<9} "
                f"max err {err:.3e} (tol {TOL[dtype]:.0e}), per row "
                f"{row:.3e} (tol {DECODE_ROW_TOL[dtype]:.0e})")
            check(math.isfinite(err) and err <= TOL[dtype],
                  f"decode_attention {name} {dtype}: err {err}")
            check(math.isfinite(row) and row <= DECODE_ROW_TOL[dtype],
                  f"decode_attention {name} {dtype}: per-row err {row}")
            del q, k, v, got, want
    log(f"[kernel] decode_attention bf16 calls on the CUDA-core kernel: "
        f"{decode_attention.narrow}")
    check(decode_attention.narrow == 0,
          "decode_attention: a bf16 case of these layouts left the ring")
    log("[kernel] decode_attention tolerance: as block_gemm's (the "
        "reference's 2e-5 / 2e-2; f32 sums and the partials' merge in "
        "another order; bf16: P rounded to bf16 before P·V and one bf16 "
        "rounding of an f32 result); per (batch, q head) row, max|kernel - "
        "plain| / max|plain| of the row, 1e-4 / 2e-2 "
        "(scripts/torch_decode_rounding.py)")
    for dtype in (torch.float32, torch.bfloat16):
        info = decode_kernel_info(dtype, 128, True, dev.index or 0)
        log(f"[kernel] decode_attention partials kernel, {str(dtype)[6:]} "
            f"D<=128 16-byte loads: {info.blocks_per_sm} resident blocks per "
            f"SM, {info.registers} registers and {info.spill_bytes} spill "
            f"bytes per thread, {info.smem_bytes} B shared, {info.ts}-"
            f"position tiles x {info.stages} (CUDA runtime)")


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
    reset_launches()
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
    return {"launches": launches, "max_batch": run.max_batch["gemm"],
            "L": L}


# The host runtime's factor against the compiled executor's, per L block as
# max|host - compiled| / max(1, max|compiled|): the same B1 on every syrk
# and gemm, one task per launch against whole wavefronts (B1 is bitwise
# batch-independent), but potrf/trsm through the library one block at a
# time against batched calls, which may round differently; a difference
# of a few f32 ulps of |L| <= ~2.5 carried through 32 panels stays near
# u * sqrt(n) ~ 8e-6, while a wrong block gives ~1. The reference's 2e-5.
HOST_TOL = 2e-5


def block_err(got: torch.Tensor, want: torch.Tensor, b: int) -> float:
    """Largest over the b x b blocks of max|got - want| / max(1, max|want|)
    within the block."""
    nb = want.shape[0] // b
    diff = (got - want).abs().view(nb, b, nb, b).amax((1, 3))
    size = want.abs().view(nb, b, nb, b).amax((1, 3)).clamp(min=1.0)
    return float((diff / size).max())


def run_host(spec, blocks, bodies, dev, **kw):
    """``run_host_ptg`` on ``inproc`` with 2 worker threads a rank; returns
    (blocks, wall ms on the host clock, which includes its final
    synchronise)."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = run_host_ptg(spec, blocks, bodies, n_threads=2, timeout=600.0,
                       transport="inproc", device=dev, **kw)
    return out, 1e3 * (time.perf_counter() - t1)


def phase_host_runtime(dev, L_compiled, nb=32, pr=2, pc=2, b=512,
                       nb_faults=8) -> dict:
    """The paper's example program on the host TaskTorrent runtime: the
    Cholesky of ``phase_cholesky`` through ``Graph.run_host``'s lowering,
    4 ranks x 2 worker threads on ``inproc``, block stores on the card."""
    # B1 is built and loaded (phase_build, phase_kernel_vs_plain) before any
    # rank starts: no worker thread builds. Held here at the host's shape,
    # one unbatched [b, b] x [b, b]^T block per launch.
    check(_build.library_path("block_gemm").exists(), "B1 not built")
    gen = torch.Generator(device=dev).manual_seed(3)
    a1 = torch.randn((b, b), generator=gen, device=dev)
    b1 = torch.randn((b, b), generator=gen, device=dev).mT
    err = rel_err(matmul(a1, b1), block_gemm_ref(a1, b1))
    log(f"[host] block_gemm [{b},{b}]@[{b},{b}].mT unbatched: max err "
        f"{err:.3e} (tol {TOL[torch.float32]:.0e})")
    check(err <= TOL[torch.float32], f"block_gemm host task shape: {err}")

    t0 = time.perf_counter()
    graph = cholesky_graph(nb, pr, pc, b)
    spec = graph.to_block_spec()
    counts = {t: 0 for t in ("potrf", "trsm", "syrk", "gemm")}
    for k in (k for v in spec.views for k in v.tasks):
        counts[spec.ptg.type_of(k)] += 1
    n_tasks = sum(counts.values())
    log(f"[host] cholesky-16k-host: N={nb * b} nb={nb} b={b}, {pr * pc} "
        f"ranks x 2 threads on inproc; {n_tasks} tasks {counts}; graph "
        f"derivation {time.perf_counter() - t0:.2f} s")
    blocks, a = make_spd_blocks(nb, b, seed=0, device=dev)
    bodies = cholesky_bodies(matmul=matmul)

    _, warm_ms = run_host(spec, blocks, bodies, dev)
    reset_launches()
    payload_stats.reset()
    out, wall_ms = run_host(spec, blocks, bodies, dev)
    launches = block_gemm.launches
    want = counts["syrk"] + counts["gemm"]
    pairs = dict(sorted(payload_stats.pairs.items()))
    log(f"[host] wall {wall_ms:.1f} ms (warm-up {warm_ms:.1f}), "
        f"{1e3 * n_tasks / wall_ms:.0f} tasks/s; block_gemm launches "
        f"{launches} (syrk + gemm tasks {want}); tensors copied on the card "
        f"{payload_stats.copied}, pickled {payload_stats.pickled}")
    log("[host] AMs and tensor bytes per rank pair (src->dst): " + ", ".join(
        f"{s}->{d} {n} {nbytes / 2 ** 20:.0f} MiB"
        for (s, d), (n, nbytes) in pairs.items()))
    check(launches == want,
          f"host runtime: block_gemm launches {launches} != {want}")
    check(payload_stats.pickled == 0 and payload_stats.copied > 0,
          f"host runtime: {payload_stats.pickled} tensors pickled, "
          f"{payload_stats.copied} copied on the card")
    check(all(t.is_cuda for t in out.values()),
          "host runtime: a result block left the card")

    L = assemble_lower(out, nb, b)
    del out
    check(bool(torch.isfinite(L).all()), "host Cholesky: non-finite L")
    resid = float(torch.linalg.vector_norm(torch.matmul(L, L.mT) - a)
                  / torch.linalg.vector_norm(a))
    err = block_err(L, L_compiled, b)
    same = bool(torch.equal(L, L_compiled))
    log(f"[host] ||L L^T - A||_F / ||A||_F = {resid:.3e} (limit "
        f"{CHOL_RESID_TOL:.0e}); against the compiled executor's factor: "
        f"{err:.3e} per L block (limit {HOST_TOL:.0e}), bit for bit: {same}")
    check(resid <= CHOL_RESID_TOL, f"host Cholesky residual {resid}")
    check(err <= HOST_TOL, f"host Cholesky vs compiled {err}")
    del L, a

    busy, busy_ms, prof_ms = profile(
        "cholesky-16k-host", lambda: run_host(spec, blocks, bodies, dev),
        detail=True)
    identity = {t: (lambda *ops: ops[0]) for t in counts}
    _, id_ms = run_host(spec, blocks, identity, dev)
    _, id_ms2 = run_host(spec, blocks, identity, dev)
    id_ms = min(id_ms, id_ms2)
    log(f"[host] runtime alone (bodies return their first operand): "
        f"{id_ms:.1f} ms, {1e3 * id_ms / n_tasks:.1f} us a task")
    del blocks

    # faults on the card: loss, duplication and rank 3 killed at its 2nd
    # user AM, as tests/test_fault_tolerance.py drives the CPU run
    g8 = cholesky_graph(nb_faults, pr, pc, b)
    spec8 = g8.to_block_spec()
    blocks8, _ = make_spd_blocks(nb_faults, b, seed=1, device=dev)
    ref, ref_ms = run_host(spec8, blocks8, bodies, dev)
    total = sum(v.stats.get("derived_edges", 0) for v in g8.local_views())
    plan = FaultPlan(seed=5, drop=0.10, duplicate=0.10, kill={3: 2})
    (got, report), fault_ms = run_host(spec8, blocks8, bodies, dev,
                                       faults=plan,
                                       rederive=g8.derive_local,
                                       total_edges=total)
    same8 = got.keys() == ref.keys() and all(
        torch.equal(got[k], ref[k]) for k in ref)
    log(f"[host] faults nb={nb_faults} b={b}: fault-free {ref_ms:.1f} ms, "
        f"faulted {fault_ms:.1f} ms, bit for bit: {same8}; RecoveryReport "
        f"{report.to_dict()}")
    check(same8, "host Cholesky under faults differs from the fault-free run")
    check(report.deaths == [3] and report.reexecuted_tasks > 0,
          f"host Cholesky under faults: {report.to_dict()}")
    del ref, got, blocks8

    reps = 50
    kernel = cuda_ms(lambda: matmul(a1, b1), reps)
    plain = cuda_ms(lambda: block_gemm_ref(a1, b1), reps)
    library = cuda_ms(lambda: torch.matmul(a1, b1), reps)
    kernel2 = cuda_ms(lambda: matmul(a1, b1), reps)
    bnd, _ = gemm_bound_ms(a1[None], b1[None])
    log(f"[time] block_gemm host task [{b},{b}]x[{b},{b}].mT: kernel "
        f"{kernel:.4f} / {kernel2:.4f} ms, plain {plain:.4f} ms, "
        f"torch.matmul {library:.4f} ms, bound {bnd:.4f} ms")
    return {"launches": launches, "wall_ms": wall_ms,
            "ms": min(kernel, kernel2), "plain_ms": plain,
            "library_ms": library, "bound_ms": bnd, "busy": busy,
            "busy_ms": busy_ms, "id_us": 1e3 * id_ms / n_tasks}


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
    reset_launches()
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


def attn_graph(depth, seq, dim, n_shards):
    """The attention chain of ``tests/multi_device_cases.py``
    (``case_pallas_bodies`` (b)): task ``l`` self-attends the previous
    layer's block."""
    g = Graph("attnchain", n_shards=n_shards,
              owner=lambda blk: blk[1] % n_shards, block_shape=(seq, dim))
    g.task_type("src",                    # publish the input as a task
                space=lambda: ((0,),),    # output (communicated blocks
                writes=lambda l: ("x", 0),  # are single-assignment)
                reads=lambda l: [("in", 0)])
    g.task_type("attn",
                space=lambda: ((l,) for l in range(1, depth + 1)),
                writes=lambda l: ("x", l),
                reads=lambda l: [("x", l - 1)] * 3)
    return g


def phase_attention_chain(dev, depth=16, seq=4096, dim=128, n_sh=2) -> dict:
    t0 = time.perf_counter()
    prog = attn_graph(depth, seq, dim, n_sh).to_program()
    gen = torch.Generator(device=dev).manual_seed(7)
    blocks = {("in", 0): torch.randn((seq, dim), generator=gen, device=dev)}
    for l in range(depth + 1):
        blocks[("x", l)] = torch.zeros((seq, dim), device=dev)
    packed = prog.pack(blocks, device=dev)
    run = prog.auto_executor({"src": lambda x: x, "attn": task_attention},
                             device=dev)
    plain = prog.auto_executor(
        {"src": lambda x: x,
         "attn": lambda q, k, v: mha_ref(q[:, None], k[:, None],
                                         v[:, None])[:, 0]}, device=dev)
    log(f"[chain] seq {seq} dim {dim} depth {depth} over {n_sh} shards: "
        f"{prog.schedule.n_wavefronts} wavefronts, mode {run.mode}; host "
        f"build {time.perf_counter() - t0:.2f} s")
    run(packed)                                   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    run.calls.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run(packed)
    end.record()
    end.synchronize()
    launches = flash_attention.launches
    log(f"[chain] task_attention bodies: {start.elapsed_time(end):.2f} ms; "
        f"flash_attention launches {launches}, executor attn calls "
        f"{run.calls['attn']}, largest batch {run.max_batch['attn']} "
        f"(the store's shards ride in one batch)")
    check(launches > 0 and launches == run.calls["attn"],
          f"chain: launches {launches} != attn calls {run.calls['attn']}")
    busy = profile("attention chain", lambda: run(packed))
    check(bool(torch.isfinite(out).all()), "chain: non-finite blocks")
    # Each task against mha_ref on the same input: the kernel's own error.
    x = prog.unpack(out)

    def task_err(l):
        prev = x[("x", l - 1)][None, None]
        return rel_err(x[("x", l)], mha_ref(prev, prev, prev)[0, 0])

    step_err = max(task_err(l) for l in range(1, depth + 1))
    plain_ms = cuda_ms(lambda: plain(packed), 1)
    ref = plain(packed)
    err = max(rel_err(out[s, slot], ref[s, slot])
              for s, slot in prog.slot_of.values())
    log(f"[chain] mha_ref bodies: {plain_ms:.2f} ms; per task, kernel vs "
        f"mha_ref on its input: max err {step_err:.3e} (tol "
        f"{TOL[torch.float32]:.0e}); whole chain vs the mha_ref-bodied run: "
        f"max err {err:.3e} (tol {CHAIN_TOL:.0e})")
    check(step_err <= TOL[torch.float32], f"chain task vs mha_ref: {step_err}")
    check(err <= CHAIN_TOL, f"chain vs mha_ref bodies: {err}")
    check(flash_attention.copies == 0, "chain: operands copied")
    # every lowering of the program gives the same blocks, bit for bit
    bodies = {"src": lambda x: x, "attn": task_attention}
    for name, kw in (("unrolled", dict(scan=False)),
                     ("dense scan", dict(scan=True)),
                     ("union cover", dict(scan=True, cover="union"))):
        other = prog.executor(bodies, device=dev, **kw)(packed)
        check(all(torch.equal(other[s, slot], out[s, slot])
                  for s, slot in prog.slot_of.values()),
              f"chain: the {name} lowering differs from {run.mode}")
    log(f"[chain] unrolled, dense-scan and union-cover lowerings: bit for "
        f"bit as {run.mode}")
    return {"launches": launches, "seq": seq, "dim": dim, "busy": busy}


@contextlib.contextmanager
def plain_ssd():
    """The model's SSD through its plain version (the chunked algorithm),
    for the comparison with the kernel."""
    kernel = mamba2.ssd
    mamba2.ssd = ssd_chunked_ref
    try:
        yield
    finally:
        mamba2.ssd = kernel


# The mamba2 model checks, as max|diff| / max|reference logits|. The
# random-weight 48-layer model amplifies a rounding difference in one layer
# roughly a thousandfold by the logits: on the CPU, 48 layers of d_model
# 256 with the plain versions only (``scripts/torch_mamba2_rounding.py``),
# the chunked SSD against the token recurrence (the same f32 function, sums
# in other orders) differ by 1.6e-4 in f32 and by 0.42 (argmax agreement
# 0.00 over 2 sequences) in bf16, and prefill against decode by 1.7e-4 in
# f32 and 0.33 in bf16. So the bf16 serving run is
# compared and reported, and the gates run the same weights with compute
# dtype f32, where the kernel's f32 path must agree to MODEL_TOL: 30x the
# CPU amplification, while a wrong layer gives differences of order 1.
MODEL_TOL = 5e-3


def compare(got, want):
    """(max|got - want| / max|want|, argmax agreement) of two logits."""
    got, want = got.float(), want.float()
    return (float((got - want).abs().max() / want.abs().max()),
            float((got.argmax(-1) == want.argmax(-1)).float().mean()))


def prefill_vs_decode(cfg, params, prompt, dev, dtype=torch.bfloat16):
    """Logits of prefill over ``prompt`` against those after feeding it
    token by token through ``decode_step`` (a ``dtype`` cache)."""
    want = make_prefill_step(cfg)(params, {"tokens": prompt})
    cache = tfm.init_cache(cfg, prompt.shape[0], prompt.shape[1], dtype=dtype,
                           device=dev)
    for t in range(prompt.shape[1]):
        logits, cache = tfm.decode_step(cfg, params, prompt[:, t], cache)
    return compare(logits, want)


def profile(label: str, fn, detail: bool = False):
    """One call of ``fn`` under ``torch.profiler``: device time by kernel
    (top 8) and the device's busy share of the wall time (kernels run on one
    stream, so their times add). Returns the busy share (NaN when the
    profiler recorded no device time), or with ``detail`` (busy share,
    device busy ms, wall ms)."""
    from torch.profiler import ProfilerActivity, profile as trace
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t1)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        log(f"[profile] {label}: the profiler recorded no device time; "
            "device busy share not measured")
        nan = float("nan")
        return (nan, nan, wall_us / 1e3) if detail else nan
    log(f"[profile] {label} under the profiler: wall {wall_us / 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms ({busy_us / wall_us:.3f} of "
        f"wall, idle share {1 - busy_us / wall_us:.3f}), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms "
            f"{e.self_device_time_total / busy_us:6.3f}  x{e.count:<5} "
            f"{e.key[:90]}")
    if detail:
        return busy_us / wall_us, busy_us / 1e3, wall_us / 1e3
    return busy_us / wall_us


def serve_tokens(cfg, params, tok, cache, n: int):
    """``n`` greedy serve steps: (tokens [B, n], last logits, cache,
    seconds on the host clock, ending in a synchronise)."""
    serve = make_serve_step(cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = []
    for _ in range(n):
        tok, logits, cache = serve(params, tok, cache)
        out.append(tok)
    sample = torch.stack(out, 1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    check(sample.shape == (tok.shape[0], n) and bool(
        ((sample >= 0) & (sample < cfg.vocab_size)).all())
        and bool(torch.isfinite(logits).all()), "serve: bad tokens")
    return sample, logits, cache, seconds


def phase_mamba2(dev, batch=4, prompt=2048, tokens=16, check_len=256) -> dict:
    cfg = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    log(f"[mamba2] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model},"
        f" d_state {cfg.ssm.d_state}, vocab {cfg.vocab_size}; {n_par / 1e9:.3f}"
        f" B params, {4 * n_par / 1e9:.2f} GB f32, compute "
        f"{cfg.compute_dtype}; init {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    step = make_prefill_step(cfg)
    with torch.inference_mode():
        step(params, {"tokens": toks[:, :256]})     # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        logits = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        launches, narrow = ssd_scan.launches, ssd_scan.narrow
        log(f"[mamba2] prefill {batch} x {prompt} tokens: {1e3 * prefill_s:.1f}"
            f" ms, {batch * prompt / prefill_s:.0f} tok/s; ssd_scan launches "
            f"{launches}, with element-wise copies {narrow}")
        check(launches == cfg.n_layers,
              f"prefill: ssd_scan launches {launches} != {cfg.n_layers}")
        check(narrow == 0, f"prefill: {narrow} ssd_scan calls copied x, B "
                           "or C element by element")
        profile("prefill", lambda: step(params, {"tokens": toks}))
        check(tuple(logits.shape) == (batch, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"prefill logits {tuple(logits.shape)} not finite/shaped")
        with plain_ssd():
            t1 = time.perf_counter()
            want = step(params, {"tokens": toks})
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
        err, agree = compare(logits, want)
        log(f"[mamba2] plain SSD prefill {1e3 * plain_s:.1f} ms; bf16 logits "
            f"kernel vs plain: {err:.3e}, argmax agreement {agree:.2f} "
            f"(reported; gated in f32 below)")
        del logits, want

        serve = make_serve_step(cfg)
        cache = tfm.init_cache(cfg, batch, prompt, device=dev)
        tok = torch.ones((batch,), dtype=torch.int64, device=dev)
        tok, _, cache = serve(params, tok, cache)    # warm-up, as the launcher
        sample, _, cache, serve_s = serve_tokens(cfg, params, tok, cache,
                                                 tokens)
        log(f"[mamba2] serve: {tokens} greedy tokens x batch {batch}: "
            f"{batch * tokens / serve_s:.1f} tok/s ({1e3 * serve_s / tokens:.2f}"
            f" ms per step; the decode step runs no kernel of the port); "
            f"sample {sample[0].tolist()}")
        del cache
        err, agree = prefill_vs_decode(cfg, params, toks[:, :check_len], dev)
        log(f"[mamba2] bf16 prefill({check_len}) vs {check_len} decode_steps:"
            f" {err:.3e}, argmax agreement {agree:.2f} (reported)")

        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        step32 = make_prefill_step(f32)
        reset_launches()
        logits = step32(params, {"tokens": toks})
        torch.cuda.synchronize()
        check(ssd_scan.launches == cfg.n_layers and ssd_scan.narrow == 0,
              "f32 prefill: launches, or element-wise copies")
        with plain_ssd():
            want = step32(params, {"tokens": toks})
        err, agree = compare(logits, want)
        log(f"[mamba2] f32 prefill {batch} x {prompt}, kernel vs plain SSD: "
            f"{err:.3e} (tol {MODEL_TOL:.0e}), argmax agreement {agree:.2f}")
        check(err <= MODEL_TOL, f"f32 prefill kernel vs plain: {err}")
        del logits, want
        err, agree = prefill_vs_decode(f32, params, toks[:, :check_len], dev)
        log(f"[mamba2] f32 prefill({check_len}) vs {check_len} decode_steps: "
            f"{err:.3e} (tol {MODEL_TOL:.0e}), argmax agreement {agree:.2f}")
        check(err <= MODEL_TOL, f"f32 prefill vs decode: {err}")
    del params
    return {"launches": launches, "prefill_ms": 1e3 * prefill_s,
            "serve_tok_s": batch * tokens / serve_s,
            "shape": [batch, prompt, cfg.ssm.n_heads(cfg.d_model),
                      cfg.ssm.head_dim, cfg.ssm.n_groups, cfg.ssm.d_state]}


@contextlib.contextmanager
def plain_attention():
    """The model's attention through the plain versions (``chunked_attention``
    for prefill, ``decode_ref`` for decode), for the comparison with B2 and
    B4."""
    kernels = tfm.prefill_attention, tfm.decode_attention_host
    tfm.prefill_attention, tfm.decode_attention_host = (chunked_attention,
                                                        decode_ref)
    try:
        yield
    finally:
        tfm.prefill_attention, tfm.decode_attention_host = kernels


# The yi-6b model checks, as max|diff| / max|reference logits|. The
# random-weight dense model hardly amplifies roundings: on the CPU, 32 layers
# of d_model 256 with yi-6b's GQA group of 8 and the plain versions only
# (``scripts/torch_dense_rounding.py``), attention in chunks against one
# block differs by 1.3e-6 in f32, prefill against decode by 1.1e-6 and a
# split-cache decode step against ``decode_ref`` by 9.9e-7; in bf16 by
# 1.6e-2 and 1.5e-2. The gates run f32 compute and hold the kernels' path
# to DENSE_TOL: ~80x the CPU gaps, room for full width's sums over 16x more
# terms (~4x the rounding), while a wrong layer gives differences of order
# 1. The bf16 comparisons are reported.
DENSE_TOL = 1e-4


def fill_cache(cache, upto: int, seed: int):
    """Seeded normal values in every layer's K and V at positions [0,
    upto): the cache after ``upto`` decoded tokens."""
    k_all, v_all = cache.layers["dense"]
    gen = torch.Generator(device=k_all.device).manual_seed(seed)
    for t in (k_all, v_all):
        for i in range(t.shape[0]):
            t[i, :, :, :upto].normal_(generator=gen)
    return cache._replace(pos=upto)


def long_step_vs_plain(cfg, params, batch: int, s: int, dev, seed=15):
    """Logits of one decode step at position s - 16 over a cache of s
    positions filled with seeded values, with B4 against ``decode_ref``;
    the cache is filled anew from the seed for each (a step writes it)."""
    dtype = tfm.dtype_of(cfg.compute_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (batch,), generator=gen,
                        device=dev)
    out = []
    for plain in (False, True):
        cache = fill_cache(tfm.init_cache(cfg, batch, s, dtype=dtype,
                                          device=dev), s - 16, seed)
        reset_launches()
        with plain_attention() if plain else contextlib.nullcontext():
            logits, _ = tfm.decode_step(cfg, params, tok, cache)
        torch.cuda.synchronize()
        check(decode_attention.launches == (0 if plain else cfg.n_layers),
              f"long-cache step: decode_attention launches "
              f"{decode_attention.launches}")
        out.append(logits)
        del cache
        torch.cuda.empty_cache()
    return compare(*out)


def phase_dense(dev, batch=4, prompt=2048, serve_batch=8, tokens=16,
                long_seq=32768, check_len=256, gate_batch=2) -> dict:
    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    log(f"[dense] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} q heads over {cfg.n_kv_heads} KV heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{n_par / 1e9:.3f} B params, {4 * n_par / 1e9:.2f} GB f32, compute "
        f"{cfg.compute_dtype}; init {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    step = make_prefill_step(cfg)
    serve = make_serve_step(cfg)
    with torch.inference_mode():
        step(params, {"tokens": toks[:, :256]})     # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        logits = step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        b2 = flash_attention.launches
        log(f"[dense] prefill {batch} x {prompt} tokens: {1e3 * prefill_s:.1f}"
            f" ms, {batch * prompt / prefill_s:.0f} tok/s; flash_attention "
            f"launches {b2}")
        check(b2 == cfg.n_layers,
              f"prefill: flash_attention launches {b2} != {cfg.n_layers}")
        log(f"[dense] flash_attention operands copied for TMA: "
            f"{flash_attention.copies}")
        check(flash_attention.copies == 0, "prefill: operands copied")
        check(tuple(logits.shape) == (batch, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"prefill logits {tuple(logits.shape)} not finite/shaped")
        prefill_busy = profile("yi-6b prefill",
                               lambda: step(params, {"tokens": toks}))
        with plain_attention():
            t1 = time.perf_counter()
            want = step(params, {"tokens": toks})
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
        err, agree = compare(logits, want)
        log(f"[dense] plain-attention prefill {1e3 * plain_s:.1f} ms; bf16 "
            f"logits kernel vs plain: {err:.3e}, argmax agreement "
            f"{agree:.2f} (reported; gated in f32 below)")
        del logits, want
        torch.cuda.empty_cache()

        # from a fresh cache, as the launcher does (its max_seq 512)
        cache = tfm.init_cache(cfg, serve_batch, 512, device=dev)
        tok = torch.ones((serve_batch,), dtype=torch.int64, device=dev)
        tok, _, cache = serve(params, tok, cache)    # warm-up
        reset_launches()
        sample, _, cache, fresh_s = serve_tokens(cfg, params, tok, cache,
                                                 tokens)
        b4 = decode_attention.launches
        log(f"[dense] serve from a fresh cache: {tokens} greedy tokens x batch "
            f"{serve_batch}: {serve_batch * tokens / fresh_s:.1f} tok/s "
            f"({1e3 * fresh_s / tokens:.2f} ms per step); decode_attention "
            f"launches {b4}; sample {sample[0].tolist()}")
        check(b4 == cfg.n_layers * tokens,
              f"fresh serve: decode_attention launches {b4}")
        check(decode_attention.narrow == 0,
              f"fresh serve: {decode_attention.narrow} bf16 B4 calls on the "
              "CUDA-core kernel")
        del cache

        # over a long cache: filled to long_seq - tokens - 2, one warm-up
        # and one profiled step, then ``tokens`` timed steps to long_seq
        cache = fill_cache(tfm.init_cache(cfg, serve_batch, long_seq,
                                          device=dev),
                           long_seq - tokens - 2, seed=14)
        tok, _, cache = serve(params, sample[:, -1], cache)     # warm-up
        last = {}
        decode_busy = profile(
            f"yi-6b decode step at position {cache.pos} of {long_seq}",
            lambda: last.update(out=serve(params, tok, cache)))
        tok, _, cache = last.pop("out")
        reset_launches()
        sample, _, cache, long_s = serve_tokens(cfg, params, tok, cache,
                                                tokens)
        b4_long = decode_attention.launches
        log(f"[dense] serve over a {long_seq}-position cache (positions "
            f"{long_seq - tokens}..{long_seq - 1}): {tokens} greedy tokens x "
            f"batch {serve_batch}: {1e3 * long_s / tokens:.2f} ms per step, "
            f"{serve_batch * tokens / long_s:.1f} tok/s; decode_attention "
            f"launches {b4_long} ({b4_long // tokens} a step); sample "
            f"{sample[0].tolist()}")
        check(cache.pos == long_seq and b4_long == cfg.n_layers * tokens,
              f"long serve: pos {cache.pos}, launches {b4_long}")
        log(f"[dense] bf16 B4 calls on the CUDA-core kernel: "
            f"{decode_attention.narrow}")
        check(decode_attention.narrow == 0,
              f"long serve: {decode_attention.narrow} bf16 B4 calls on the "
              "CUDA-core kernel")
        del cache
        torch.cuda.empty_cache()
        err, agree = long_step_vs_plain(cfg, params, serve_batch, long_seq,
                                        dev)
        log(f"[dense] bf16 decode step at position {long_seq - 16} of "
            f"{long_seq}, batch {serve_batch}, B4 vs decode_ref: {err:.3e}, "
            f"argmax agreement {agree:.2f} (reported)")
        err, agree = prefill_vs_decode(cfg, params, toks[:, :check_len], dev)
        log(f"[dense] bf16 prefill({check_len}) vs {check_len} decode_steps: "
            f"{err:.3e}, argmax agreement {agree:.2f} (reported)")

        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        step32 = make_prefill_step(f32)
        reset_launches()
        logits = step32(params, {"tokens": toks})
        torch.cuda.synchronize()
        check(flash_attention.launches == cfg.n_layers, "f32 prefill: launches")
        with plain_attention():
            want = step32(params, {"tokens": toks})
        err, agree = compare(logits, want)
        log(f"[dense] f32 prefill {batch} x {prompt}, B2 vs plain attention: "
            f"{err:.3e} (tol {DENSE_TOL:.0e}), argmax agreement {agree:.2f}")
        check(err <= DENSE_TOL, f"f32 prefill kernel vs plain: {err}")
        del logits, want
        torch.cuda.empty_cache()
        err, agree = prefill_vs_decode(f32, params, toks[:, :check_len], dev,
                                       dtype=torch.float32)
        log(f"[dense] f32 prefill({check_len}) vs {check_len} decode_steps: "
            f"{err:.3e} (tol {DENSE_TOL:.0e}), argmax agreement {agree:.2f}")
        check(err <= DENSE_TOL, f"f32 prefill vs decode: {err}")
        err, agree = long_step_vs_plain(f32, params, gate_batch, long_seq,
                                        dev)
        log(f"[dense] f32 decode step at position {long_seq - 16} of "
            f"{long_seq}, batch {gate_batch}, B4 vs decode_ref: {err:.3e} "
            f"(tol {DENSE_TOL:.0e}), argmax agreement {agree:.2f}")
        check(err <= DENSE_TOL, f"f32 long-cache step B4 vs plain: {err}")
    del params
    return {"b2_launches": b2, "b4_launches": b4_long,
            "b4_per_step": b4_long // tokens, "prefill_ms": 1e3 * prefill_s,
            "prefill_busy": prefill_busy, "decode_busy": decode_busy,
            "long_ms": 1e3 * long_s / tokens}


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
        a, b = gemm_operands(gen, dev, torch.float32, T, m, k, n,
                             b_n=not tr)
        got = block_gemm(a, b)
        err = float((got - block_gemm_ref(a, b)).abs().max())
        reps = 5
        kernel = cuda_ms(lambda: block_gemm(a, b), reps)
        plain = cuda_ms(lambda: block_gemm_ref(a, b), reps)
        library = cuda_ms(lambda: torch.bmm(a, b), reps)
        kernel2 = cuda_ms(lambda: block_gemm(a, b), reps)
        bnd, bound_by = gemm_bound_ms(a, b)
        label = f"{name} [{T},{m},{k}]x[{T},{k},{n}]"
        log(f"[time] block_gemm {label}: kernel {kernel:.3f} / {kernel2:.3f} "
            f"ms, plain {plain:.3f} ms, torch.bmm {library:.3f} ms, bound "
            f"{bnd:.3f} ms ({bound_by}); {2e-9 * T * m * n * k / kernel:.1f} "
            f"TFLOP/s")
        rows[name] = {"ms": min(kernel, kernel2), "plain_ms": plain,
                      "library_ms": library, "bound_ms": bnd,
                      "bound_by": bound_by, "max_abs_err": err,
                      "shape": [T, m, k, n]}
        del a, b, got
    return rows


def phase_time_attention(dev, seq: int, dim: int) -> dict:
    """B2 at the attention chain's task ([1, 1, seq, dim] f32, causal, one
    task per launch), at yi-6b's prefill layout ([1, 32|4, 4096, 128]
    bf16) and at the model's own prefill call ([4, 32|4, 2048, 128] bf16,
    strided views): the kernel, its plain version and
    ``scaled_dot_product_attention`` (timed only), with each path's
    registers, spills and resident blocks."""
    gen = torch.Generator(device=dev).manual_seed(5)
    yi = get_config("yi-6b")
    hq, hkv, hd = yi.n_heads, yi.n_kv_heads, yi.head_dim
    rows = {}
    for name, shape, model, dtype in (
            ("chain task", (1, 1, 1, seq, seq, dim), False, torch.float32),
            ("yi-6b prefill", (1, hq, hkv, 4096, 4096, hd), False,
             torch.bfloat16),
            ("yi-6b model prefill", (4, hq, hkv, 2048, 2048, hd), True,
             torch.bfloat16)):
        q, k, v = attention_operands(gen, dev, dtype, *shape, model=model)
        got = flash_attention(q, k, v)
        err = float((got.float() - mha_ref(q, k, v).float()).abs().max())
        gqa = q.shape[1] != k.shape[1]
        reps = 5
        kernel = cuda_ms(lambda: flash_attention(q, k, v), reps)
        plain = cuda_ms(lambda: mha_ref(q, k, v), reps)
        library = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=gqa), reps)
        kernel2 = cuda_ms(lambda: flash_attention(q, k, v), reps)
        nbytes, flops = attention_work(q, k)
        bnd, bound_by = bound(nbytes, flops, dtype)
        info = attention_kernel_info(dtype, q.shape[3], dev.index or 0)
        log(f"[time] flash_attention {name} q{list(q.shape)} "
            f"kv{list(k.shape)} {str(dtype)[6:]}: kernel {kernel:.3f} / "
            f"{kernel2:.3f} ms, plain {plain:.3f} ms, sdpa {library:.3f} ms, "
            f"bound {bnd:.3f} ms ({bound_by}); kernel "
            f"{1e-9 * flops / min(kernel, kernel2):.1f} TFLOP/s, sdpa "
            f"{1e-9 * flops / library:.1f} TFLOP/s; {info.registers} "
            f"registers, {info.spill_bytes} spill bytes, "
            f"{info.blocks_per_sm} blocks per SM")
        rows[name] = {"ms": min(kernel, kernel2), "plain_ms": plain,
                      "library_ms": library, "bound_ms": bnd,
                      "bound_by": bound_by, "max_abs_err": err,
                      "shape": [list(q.shape), list(k.shape),
                                str(dtype)[6:]]}
        del q, k, v, got
    return rows


def phase_time_ssd(dev, shape) -> dict:
    """B3 at mamba2-1.3b's layer at prefill, in the model's layout (x, B
    and C views of one projection): bf16 at Q 128 (the model's; the row
    returned) and Q 256, f32 at Q 128; the kernels and their plain version.
    No single PyTorch call computes the SSD scan, so there is no library
    time."""
    b, l, h, p, g, n = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    row = None
    for dtype, q in ((torch.bfloat16, 128), (torch.bfloat16, 256),
                     (torch.float32, 128)):
        ops = ssd_operands(gen, dev, dtype, b, l, h, g, p, n, model=True)
        got = ssd_scan(*ops, q_chunk=q)
        err = float((got.float() - ssd_chunked_ref(*ops, q_chunk=q).float())
                    .abs().max())
        reps = 10
        kernel = cuda_ms(lambda: ssd_scan(*ops, q_chunk=q), reps)
        plain = cuda_ms(lambda: ssd_chunked_ref(*ops, q_chunk=q), 3)
        kernel2 = cuda_ms(lambda: ssd_scan(*ops, q_chunk=q), reps)
        nbytes, flops = ssd_work(ops[0], ops[3], q)
        bnd, bound_by = bound(nbytes, flops, dtype)
        kernels = ssd_plan(b, l, h, g, p, n, q, got.element_size()).kernels
        log(f"[time] ssd_scan mamba2-1.3b layer x[{b},{l},{h},{p}] "
            f"b/c[{b},{l},{g},{n}] {str(dtype)[6:]} Q{q}: kernel "
            f"{kernel:.3f} / {kernel2:.3f} ms ({kernels} kernels a call), "
            f"plain {plain:.3f} ms, library none, bound {bnd:.3f} ms "
            f"({bound_by}); kernel {1e-9 * flops / min(kernel, kernel2):.1f} "
            f"TFLOP/s, {1e-6 * nbytes / min(kernel, kernel2):.0f} GB/s")
        if row is None:      # the model's own call
            row = {"ms": min(kernel, kernel2), "plain_ms": plain,
                   "library_ms": None, "bound_ms": bnd, "bound_by": bound_by,
                   "max_abs_err": err, "shape": list(shape) + ["bfloat16", q],
                   "kernels_per_call": kernels}
        del ops, got
    return row


def phase_time_decode(dev) -> dict:
    """B4 at yi-6b's decode layer over the long cache (q [8, 32, 128], K/V
    [8, 4, 32768, 128], bf16, every position live): the kernel, its plain
    version and ``scaled_dot_product_attention`` with the length mask
    (timed only)."""
    b, hq, hkv, s, d = DECODE_CELL
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = decode_operands(gen, dev, torch.bfloat16, b, hq, hkv, s, d)
    kv_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]
    got = decode_attention(q, k, v, kv_len)
    want = decode_ref(q, k, v, kv_len)
    err = float((got.float() - want.float()).abs().max())
    row = row_err(got, want)
    log(f"[time] decode_attention all-live cell: per-row err {row:.3e} (tol "
        f"{DECODE_ROW_TOL[torch.bfloat16]:.0e})")
    check(math.isfinite(row) and row <= DECODE_ROW_TOL[torch.bfloat16],
          f"decode_attention all-live cell: per-row err {row}")
    del want
    reps = 20
    kernel = cuda_ms(lambda: decode_attention(q, k, v, kv_len), reps)
    plain = cuda_ms(lambda: decode_ref(q, k, v, kv_len), 3)
    library = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True), reps)
    kernel2 = cuda_ms(lambda: decode_attention(q, k, v, kv_len), reps)
    live = int(kv_len.sum())      # cache positions read, over the batch
    nbytes = q.element_size() * (2 * q.numel() + 2 * hkv * d * live)
    bnd, bound_by = bound(nbytes, 4.0 * d * hq * live, torch.bfloat16)
    log(f"[time] decode_attention yi-6b decode layer q[{b},{hq},{d}] "
        f"kv[{b},{hkv},{s},{d}] bf16: kernel {kernel:.3f} / {kernel2:.3f} "
        f"ms, plain {plain:.3f} ms, sdpa {library:.3f} ms, bound {bnd:.3f} "
        f"ms ({bound_by}); kernel {1e-6 * nbytes / min(kernel, kernel2):.0f} "
        f"GB/s")
    return {"ms": min(kernel, kernel2), "plain_ms": plain,
            "library_ms": library, "bound_ms": bnd, "bound_by": bound_by,
            "max_abs_err": err, "shape": [[b, hq, d], [b, hkv, s, d],
                                          "bfloat16"]}


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
    phase_attention_vs_plain(dev)
    phase_ssd_vs_plain(dev)
    phase_decode_vs_plain(dev)
    torch.cuda.empty_cache()
    chol = phase_cholesky(dev)
    torch.cuda.empty_cache()
    host = phase_host_runtime(dev, chol.pop("L"))
    torch.cuda.empty_cache()
    gemm = phase_gemm(dev)
    torch.cuda.empty_cache()
    chain = phase_attention_chain(dev)
    torch.cuda.empty_cache()
    model = phase_mamba2(dev)
    torch.cuda.empty_cache()
    dense = phase_dense(dev)
    torch.cuda.empty_cache()
    times = phase_yardstick(dev, chol["max_batch"], gemm["max_batch"])
    attn_times = phase_time_attention(dev, chain["seq"], chain["dim"])
    ssd_time = phase_time_ssd(dev, model["shape"])
    decode_time = phase_time_decode(dev)
    log(f"[done] {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; GEMM main "
        f"path launches {gemm['launches']}")
    rows = [("block_gemm", "block_gemm/block_gemm.py:40", chol["launches"],
             times["cholesky gemm"]),
            ("flash_attention", "flash_attention/flash_attention.py:76",
             chain["launches"], attn_times["chain task"]),
            ("ssd_scan", "ssd_scan/ssd_scan.py:68", model["launches"],
             ssd_time),
            ("decode_attention", "decode_attention/decode_attention.py:65",
             dense["b4_per_step"], decode_time)]
    # B1 on the host runtime's path: one unbatched block a launch
    extra = {"block_gemm": {
        "host_launches": host["launches"], "host_ms": host["ms"],
        "host_plain_ms": host["plain_ms"],
        "host_library_ms": host["library_ms"],
        "host_bound_ms": host["bound_ms"]}}
    log("kernels: " + ", ".join(name for name, *_ in rows))
    log(card())
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": f"src/repro/kernels/{where}", "launches": launches,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": row["shape"], **extra.get(name, {})}
        for name, where, launches, row in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
