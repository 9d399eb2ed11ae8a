"""Run ``chip_smoke.py``'s tensor-parallel serving phase alone on the GPU:
build the kernels, run ``phase_tensor_ranks`` (each cell of ``TP_CELLS``
on rank processes that share the card, against its one-process
yardstick: yi-6b-d16-tp2-r2, starcoder2-3b-d10-tp4-r4, grok-1-314b-d4-tp4-r4,
deepseek-v3-671b-d5-tp4-r4, grok-1-314b-d2-dp2-tp2-r4,
mamba2-1.3b-d6-tp4-r4, zamba2-1.2b-d14-tp4-r4,
seamless-m4t-large-v2-d6-tp2-r2, seamless-m4t-large-v2-tp4-r4) and time
B2, B3 and B4 at the ranks' per-shard layouts.

    python3 scripts/torch_tensor_ranks.py [cell ...]

Names of cells pick some, run in that order (all by default). Needs one
CUDA GPU and nvcc. Prints what the phase prints, with the card's name and
power limit on every line of numbers.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (name, B2 layout (b, hq, hkv, lq, lk, d), its window, B4 layout (b, hq,
# hkv, s, d))
SHARDS = (("yi-6b tp2", (1, 16, 2, 2048, 2048, 128), 0,
           (8, 16, 2, 32768, 128)),
          ("starcoder2-3b tp4", (1, 6, 1, 2048, 2048, 128), 0,
           (8, 6, 1, 4096, 128)),
          ("grok-1-314b tp4", (1, 12, 2, 2048, 2048, 128), 0,
           (8, 12, 2, 4096, 128)),
          ("zamba2-1.2b tp4", (1, 8, 8, 4608, 4608, 64), 4096,
           (8, 8, 8, 4096, 64)),
          ("seamless-m4t-large-v2 tp4 decoder", (1, 4, 4, 512, 512, 64), 0,
           (8, 4, 4, 4096, 64)))
# B3 at mamba2-1.3b's shard on 4 ranks: (b, l, h, p, g, n)
SSD_SHARD = [1, 2048, 16, 64, 1, 128]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tensor_ranks: needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cs.log(cs.card())
    cs.phase_build()
    cs.log(f"[tensor ranks] build {time.perf_counter() - t0:.1f} s")
    names = sys.argv[1:]
    out = cs.phase_tensor_ranks(dev, cells=[
        c for n in names for c in cs.TP_CELLS if c[0] == n] or cs.TP_CELLS)
    cs.log(f"[tensor ranks] launches per rank {out}")
    cs.log(f"[tensor ranks] peak device memory of this process "
           f"{cs.run_peak() / 1e9:.2f} GB [{cs.card()}]")
    gen = torch.Generator(device=dev).manual_seed(5)
    for name, attn, win, decode in SHARDS:
        q, k, v = cs.attention_operands(gen, dev, torch.bfloat16, *attn,
                                        model=True)
        mask = None
        if win:      # SDPA with the window as an explicit band
            pos = torch.arange(q.shape[2], device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                                     > pos[:, None] - win)
        kernel = cs.cuda_ms(lambda: cs.flash_attention(q, k, v, window=win),
                            5)
        plain = cs.cuda_ms(lambda: cs.mha_ref(q, k, v, window=win), 5)
        library = cs.cuda_ms(lambda: cs.F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True), 5)
        bnd, by = cs.bound(*cs.attention_work(q, k, True, win),
                           torch.bfloat16)
        cs.log(f"[time] flash_attention {name} prefill shard {list(q.shape)} "
               f"kv {list(k.shape)}{' window %d' % win if win else ''}: "
               f"kernel {kernel:.3f} ms, plain {plain:.3f} ms, sdpa "
               f"{library:.3f} ms, bound {bnd:.3f} ms ({by}) [{cs.card()}]")
        del q, k, v, mask
        cs.phase_time_decode(dev, decode, f"{name} decode shard")
    cs.phase_time_ssd(dev, SSD_SHARD, "mamba2-1.3b tp4 shard", False)
    cs.log(f"[tensor ranks] total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
