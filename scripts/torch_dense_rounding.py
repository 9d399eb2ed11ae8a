"""How much a deep random-weight dense (yi-6b-shaped) model amplifies
rounding differences.

    PYTHONPATH=src python scripts/torch_dense_rounding.py [--layers 32]

Runs on the CPU with the port's plain versions only (no kernel): a yi-6b
model of ``--layers`` layers (its depth by default) at ``--d-model`` (GQA
group 8 as in yi-6b: 8 q heads over 1 KV head of 32, SwiGLU of 688, vocab
2048, seeded weights), in f32 and in bf16 compute, and prints three
comparisons of last-position logits as max|a - b| / max|b| and argmax
agreement:

- prefill over the prompt against feeding it token by token through
  ``decode_step`` (the model's invariant);
- prefill with attention in one block against attention in chunks of 16
  (``chunked_attention``'s online softmax: one function, sums in other
  orders; the plain counterpart of B2 against its plain version);
- the last decode step with ``decode_ref`` against the same step with a
  split-cache merge (partials over ranges of 32 positions, merged as B4
  merges them: one function, sums in other orders).

Both sides of each pair compute the same function, so the gaps are
roundings carried through the layers. ``chip_smoke.py`` sets its dense
model tolerances from them.
"""

import argparse
import contextlib
import dataclasses
import os

import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tfm


def gap(a, b):
    a, b = a.float(), b.float()
    return (float((a - b).abs().max() / b.abs().max()),
            float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def split_decode(q, k, v, kv_len, split=32):
    """decode_ref's function as partials over cache ranges of ``split``
    positions, merged by their maxima and sums (the algorithm of B4)."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    kx = k.repeat_interleave(hq // hkv, dim=1).float()
    vx = v.repeat_interleave(hq // hkv, dim=1).float()
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kx) * d ** -0.5
    live = torch.arange(s)[None, None, :] < kv_len[:, None, None]
    logits = logits.masked_fill(~live, float("-inf"))
    ms, ls, accs = [], [], []
    for s0 in range(0, s, split):
        part = logits[..., s0:s0 + split]
        m = part.amax(-1, keepdim=True).clamp_min(-1e30)
        p = torch.exp(part - m)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bhs,bhsd->bhd", p, vx[:, :, s0:s0 + split]))
    m_all = torch.stack(ms).amax(0)
    w = [torch.exp(m - m_all) for m in ms]
    den = sum(wi * li for wi, li in zip(w, ls))
    num = sum(wi * ai for wi, ai in zip(w, accs))
    return (num / den).to(q.dtype)


@contextlib.contextmanager
def decode_attention_by(fn):
    kernel, tfm.decode_attention_host = tfm.decode_attention_host, fn
    try:
        yield
    finally:
        tfm.decode_attention_host = kernel


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    base = reduced(get_config("yi-6b"), n_layers=args.layers,
                   d_model=args.d_model, n_heads=8, n_kv_heads=1, d_head=32,
                   d_ff=688, vocab_size=2048)
    params = tfm.init_params(base, seed=0, device="cpu")
    toks = torch.randint(0, base.vocab_size, (args.batch, args.seq),
                         generator=torch.Generator().manual_seed(1))
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        with torch.inference_mode():
            one_block = tfm.prefill(cfg, params, tokens=toks)
            os.environ["REPRO_ATTN_CHUNK"] = "16"
            try:
                chunked = tfm.prefill(cfg, params, tokens=toks)
            finally:
                del os.environ["REPRO_ATTN_CHUNK"]
            cache = tfm.init_cache(cfg, args.batch, args.seq,
                                   dtype=getattr(torch, dtype), device="cpu")
            for t in range(args.seq - 1):
                decoded, cache = tfm.decode_step(cfg, params, toks[:, t],
                                                 cache)
            k, v = (c.clone() for c in cache.layers["dense"])
            decoded, _ = tfm.decode_step(cfg, params, toks[:, -1], cache)
            cache = cache._replace(layers={"dense": (k, v)})
            with decode_attention_by(split_decode):
                split, _ = tfm.decode_step(cfg, params, toks[:, -1], cache)
        print(f"{dtype:<9} {args.layers} layers d_model {args.d_model}: "
              "prefill vs decode %.3e (argmax %.2f); attention in chunks of "
              "16 vs one block %.3e (argmax %.2f); split-cache decode vs "
              "decode_ref %.3e (argmax %.2f)"
              % (*gap(decoded, one_block), *gap(chunked, one_block),
                 *gap(split, decoded)))


if __name__ == "__main__":
    main()
