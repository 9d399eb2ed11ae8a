"""How far one process's f32 training gradient moves when only the order
of its f32 sums changes, on the GPU: ``loss_and_grads`` of
``chip_smoke.py``'s ranked train cells (zamba2-1.2b-d13, mamba2-1.3b-d6,
seamless-m4t-large-v2-d6 at full width, f32 compute, seed 0, the phase's
batch) at the default chunk lengths and again with the SSD's
(``REPRO_SSD_CHUNK``) or the attention's KV chunk (``REPRO_ATTN_CHUNK``)
changed: the same function summed in other orders. Prints per change the
losses, |g| and the largest gap of a leaf's gradient over its max|g|,
with the card's name and power limit. ``chip_smoke.py``'s TP_F32_NOISE
reads these gaps.

    python3 scripts/torch_train_sum_order.py

Needs one CUDA GPU (~20 s).
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
from repro_torch.train.tree import leaf_paths  # noqa: E402

# (name, arch, layers, the batch's tokens and frames, the changes)
CELLS = (("zamba2-d13", "zamba2-1.2b", 13, {},
          [{"REPRO_SSD_CHUNK": "64"}, {"REPRO_SSD_CHUNK": "256"},
           {"REPRO_ATTN_CHUNK": "256"}]),
         ("mamba2-d6", "mamba2-1.3b", 6, {},
          [{"REPRO_SSD_CHUNK": "64"}, {"REPRO_SSD_CHUNK": "256"}]),
         ("seamless-d6", "seamless-m4t-large-v2", 6,
          {"seq": 512, "frames": 2048},
          [{"REPRO_ATTN_CHUNK": "256"}, {"REPRO_ATTN_CHUNK": "512"}]))


def grads(cfg, batch, dev, **envs):
    """(loss, {leaf: gradient}) of the seed-0 weights on ``batch`` with
    the environment ``envs`` set."""
    params = cs.tfm.init_params(cfg, seed=0, device=dev)
    with cs.env(**envs):
        loss, g = loss_and_grads(cfg, params,
                                 {k: v.to(dev) for k, v in batch.items()})
    return float(loss), {n: t.detach() for n, t in leaf_paths(g)}


def gap(a, b):
    """(the largest max|a - b| / max|a| over the leaves, its leaf)."""
    worst = (0.0, "")
    for n in a:
        top = float(a[n].abs().max())
        worst = max(worst, (float((a[n] - b[n]).abs().max())
                            / max(top, 1e-30), n))
    return worst


def norm(g):
    return float(torch.sqrt(sum(torch.sum(t.float() ** 2)
                                for t in g.values())))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_sum_order: needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    for name, arch, layers, opts, knobs in CELLS:
        cfg = cs.tp_train_config(arch, layers, "float32")
        batch = cs.tp_train_batch(cfg, 1, opts.get("seq", 2048),
                                  opts.get("frames", 0))
        t0 = time.time()
        l0, g0 = grads(cfg, batch, dev)
        for k in knobs:
            l1, g1 = grads(cfg, batch, dev, **k)
            print(f"{name} {k}: loss {l0} vs {l1} ({abs(l0 - l1) / l0:.3e}),"
                  f" |g| {norm(g0):.6f} vs {norm(g1):.6f}, worst leaf gap "
                  f"{gap(g0, g1)} [{cs.card()}]", flush=True)
            del g1
        del g0
        torch.cuda.empty_cache()
        print(name, "s", time.time() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
