"""Where B2's f32 path spends its time, and what the attention chain waits
on, on one CUDA GPU.

    python scripts/torch_flash_attention_probe.py

Builds copies of ``csrc/flash_attention.cu`` with one part of the f32
partials kernel taken out or unrolled further (into the kernels' build
directory, which git ignores), and prints for each the partials kernel's
device time (``torch.profiler``) on the attention chain's task
[T, 1, 4096, 128] f32: T = 1 and 2 causal (the chain's launches carry 2
tasks) and T = 1 full. The copies without a phase compute wrong results:
they are timed, never used. Then it runs the attention-chain PTG (seq
4096, dim 128, depth 16, 2 shards) with ``task_attention`` bodies and with
bodies that return their input, and prints each run's CUDA-event time and
its host enqueue time (the host clock until the last launch returns).
Prints the card's name and power limit first.
"""

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import task_attention  # noqa: E402
import repro_torch.kernels.flash_attention.flash_attention  # noqa: E402,F401

FA = sys.modules["repro_torch.kernels.flash_attention.flash_attention"]

S_LOOP = "#pragma unroll 2\n    for (int dd = 0; dd < dpad; dd += 4) {"
PV_LOOP = "    for (int j = 0; j < jn; ++j) {"
NO_S = "#pragma unroll 2\n    for (int dd = 0; dd < 0; dd += 4) {"
NO_PV = "    for (int j = 0; j < 0; ++j) {"


def variants(src):
    """Name -> source; each edit must find its text."""
    assert S_LOOP in src and PV_LOOP in src
    return {
        "as built": src,
        "without P·V": src.replace(PV_LOOP, NO_PV),
        "without Q·Kᵀ": src.replace(S_LOOP, NO_S),
        "without either": src.replace(PV_LOOP, NO_PV).replace(S_LOOP, NO_S),
        "Q·Kᵀ unroll 8, P·V unroll 8": src.replace(
            S_LOOP, S_LOOP.replace("unroll 2", "unroll 8")).replace(
            PV_LOOP, "#pragma unroll 8\n" + PV_LOOP),
    }


def partials_us(x, causal):
    """Mean device time of the partials kernel over 8 launches."""
    FA.flash_attention(x, x, x, causal=causal)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            FA.flash_attention(x, x, x, causal=causal)
        torch.cuda.synchronize()
    return [e.self_device_time_total / e.count for e in prof.key_averages()
            if "partial_kernel" in e.key][0]


def chain_ms(prog, packed, attn, dev):
    run = prog.auto_executor({"src": lambda x: x, "attn": attn}, device=dev)
    run(packed)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run(packed)
    end.record()
    host = 1e3 * (time.perf_counter() - t0)
    end.synchronize()
    return start.elapsed_time(end), host


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_flash_attention_probe: needs a CUDA GPU")
    dev = torch.device("cuda")
    print(chip_smoke.card(), flush=True)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out = _build.BUILD / "probe"
    out.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = {(t, c): torch.randn((t, 1, 4096, 128), generator=gen, device=dev)
          for t, c in ((1, True), (2, True), (1, False))}
    for i, (name, text) in enumerate(variants(src).items()):
        cu, so = out / f"v{i}.cu", out / f"v{i}.so"
        cu.write_text(text)
        subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(so),
                        str(cu)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        _build.load = lambda name, lib=lib: lib
        for cached in (FA._entry, FA.kernel_info, FA._f32_launch):
            cached.cache_clear()
        times = {key: partials_us(x, key[1]) for key, x in xs.items()}
        print(f"[partials] {name}: " + "; ".join(
            f"T={t} {'causal' if c else 'full'} {us:.1f} us"
            for (t, c), us in times.items()), flush=True)
    prog = chip_smoke.attn_graph(16, 4096, 128, 2).to_program()
    blocks = {("in", 0): torch.randn((4096, 128), generator=gen, device=dev)}
    for l in range(17):
        blocks[("x", l)] = torch.zeros((4096, 128), device=dev)
    packed = prog.pack(blocks, device=dev)
    for name, attn in (("task_attention", task_attention),
                       ("identity", lambda q, k, v: q)):
        for _ in range(2):
            ms, host = chain_ms(prog, packed, attn, dev)
            print(f"[chain] {name} bodies: {ms:.2f} ms, host enqueue "
                  f"{host:.2f} ms", flush=True)


if __name__ == "__main__":
    main()
