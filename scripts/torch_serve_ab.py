"""yi-6b serving on one GPU from the checkout at ``TREE``: the prefill of 4
x 2 048 seeded tokens (best of 3) and 16 decode steps at batch 8 over a
32 768-position cache of seeded values, f32 weights, bf16 compute.

    python3 scripts/torch_serve_ab.py TREE LABEL

Compares two commits on one card: unpack each into a directory, then run
them in turns (parent, change, change, parent) in one command, e.g.
``for t in A B B A; do python3 scripts/torch_serve_ab.py $t $t; done``.
Prints one line a run with LABEL.
"""

import sys
import time


def main(tree: str, label: str) -> None:
    sys.path.insert(0, tree + "/src")
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, dev = get_config("yi-6b"), torch.device("cuda")
    params = tfm.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen,
                         device=dev)
    step = make_prefill_step(cfg)
    serve = make_serve_step(cfg)
    with torch.inference_mode():
        step(params, {"tokens": toks[:, :256]})
        pre = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, {"tokens": toks})
            torch.cuda.synchronize()
            pre.append(1e3 * (time.perf_counter() - t0))
        cache = tfm.init_cache(cfg, 8, 32768, device=dev)
        for t in cache.layers["dense"]:
            for i in range(t.shape[0]):
                t[i, :, :, :32740].normal_(generator=gen)
        cache = cache._replace(pos=32740)
        tok = torch.ones((8,), dtype=torch.int64, device=dev)
        for _ in range(2):
            tok, _, cache = serve(params, tok, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            tok, _, cache = serve(params, tok, cache)
        torch.cuda.synchronize()
        dec = 1e3 * (time.perf_counter() - t0) / 16
    print(f"{label}: {torch.cuda.get_device_name(dev)}; prefill 4x2048 "
          f"{min(pre):.1f} ms (of {[round(p, 1) for p in pre]}), "
          f"decode-32k {dec:.2f} ms a step", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
