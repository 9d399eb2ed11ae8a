"""The attention chain: a block PTG whose tasks are attention calls.

The chain of the JAX package's ``tests/multi_device_cases.py``
(``case_pallas_bodies`` (b)): task ``l`` self-attends the previous task's
``[seq, dim]`` block (q = k = v), and the blocks alternate between shards,
so every task waits for the previous one's block to cross. Its ``attn``
body is B2 (``kernels.flash_attention.task_attention``), one launch per
wavefront; the plain body is ``mha_ref`` on the same operands.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.dist.ranks import run_program
from repro_torch.kernels.flash_attention import mha_ref, task_attention
from repro_torch.ptg import Graph


def chain_graph(depth: int, seq: int, dim: int, n_shards: int) -> Graph:
    """``src`` publishes the input as ``("x", 0)`` (communicated blocks are
    single-assignment); ``attn`` ``l`` writes ``("x", l)`` from ``("x",
    l - 1)``. Block ``("x", l)`` lives on shard ``l % n_shards``."""
    g = Graph("attnchain", n_shards=n_shards,
              owner=lambda blk: blk[1] % n_shards, block_shape=(seq, dim))
    g.task_type("src",
                space=lambda: ((0,),),
                writes=lambda l: ("x", 0),
                reads=lambda l: [("in", 0)])
    g.task_type("attn",
                space=lambda: ((l,) for l in range(1, depth + 1)),
                writes=lambda l: ("x", l),
                reads=lambda l: [("x", l - 1)] * 3)
    return g


def chain_bodies(kernel: bool = True) -> Dict[str, object]:
    """``attn`` through B2 (``kernel``) or through ``mha_ref``."""
    def plain(q, k, v):
        return mha_ref(q[:, None], k[:, None], v[:, None])[:, 0]

    return {"src": lambda x: x, "attn": task_attention if kernel else plain}


def chain_blocks(depth: int, seq: int, dim: int, seed: int = 7,
                 device="cuda") -> Dict[Tuple, torch.Tensor]:
    """The input drawn on ``device`` from a ``torch.Generator`` seeded with
    ``seed``; every ``("x", l)`` zero."""
    gen = torch.Generator(device=device).manual_seed(seed)
    blocks = {("in", 0): torch.randn((seq, dim), generator=gen,
                                     device=device)}
    for l in range(depth + 1):
        blocks[("x", l)] = torch.zeros((seq, dim), device=device)
    return blocks


def chain_rank(rank: int, world: int, depth: int, seq: int, dim: int, runs,
               *, device, seed: int = 7, kernel: bool = True,
               keep=None) -> list:
    """One rank's part of the chain over a process group of one rank per
    shard (``dist.ranks.spawn_ranks`` names it): ``runs`` on the rank's
    shard (see ``dist.ranks.run_program``, which gives what it returns)."""
    prog = chain_graph(depth, seq, dim, world).to_program()
    return run_program(prog, chain_bodies(kernel),
                       chain_blocks(depth, seq, dim, seed, device), runs,
                       device=device, keep=keep)
