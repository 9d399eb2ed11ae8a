"""Distributed block GEMM as a declarative PTG — the paper's §III-B app.

Two mappings, as in the paper, both declared once through the
``repro_torch.ptg`` front-end (task types + reads/writes access patterns); all
edge functions — including the per-k accumulation chains and the broadcast
out-edges of the send tasks — are *derived*, not hand-written:

- **2D block-cyclic** (`gemm_2d_graph`): C_ij owned by shard
  (i mod pr, j mod pc); contributions A_ik·B_kj sequence in k on the owner
  of C_ij automatically, because every k-step read-modify-writes the same
  C block — the exact `gemm_Cikj` PTG of the paper (indegree
  ``k == 0 ? 2 : 3``), with send tasks broadcasting A along grid rows and
  B along grid columns via the executor's exchanges.
- **3D DNS** (`gemm_3d_graph`): the k-range is sliced into q slabs; each
  slab plane accumulates a partial product which a reduction chain sums
  into C — less comm per plane, one extra reduction stage (Fig 7a-b/d).

``staged=True`` adds an ``after`` control chain through the send tasks so
the A_ik / B_kj broadcasts happen at wavefront k instead of all at
wavefront 0: the schedule then overlaps each step's exchange with the previous step's
compute and needs O(nb/p) message buffers instead of O(nb²/p²).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import (BlockExecutor, BlockProgram,
                                       BlockPTGSpec, build_block_program)
from repro_torch.dist.ranks import run_program
from repro_torch.kernels.block_gemm.ops import task_matmul
from repro_torch.ptg import Graph, IndexSpace


def _res(p: int, r: int, n: int):
    """Indices in [0, n) congruent to r mod p — one block-cyclic residue
    class, the strip a shard owns along one grid dimension."""
    return range(r % p, n, p)


# ------------------------------------------------------------- 2D mapping

def gemm_2d_graph(nb: int, pr: int, pc: int, b: int, *, staged: bool = False,
                  dtype=torch.float32) -> Graph:
    """nb×nb blocks of size b×b on a pr×pc shard grid, declared once."""

    def owner(blk) -> int:
        kind, r, c = blk
        return (r % pr) * pc + (c % pc)

    g = Graph("gemm2d", n_shards=pr * pc, owner=owner,
              block_shape=(b, b), dtype=dtype)
    # partitionable grid spaces: each type's written block fixes a block-
    # cyclic residue class per shard, so derive_local's pass 1 enumerates
    # only the shard's strip instead of relevance-filtering the whole grid
    g.task_type(
        "sa",
        space=IndexSpace(
            lambda: ((i, kk) for i in range(nb) for kk in range(nb)),
            lambda s: ((i, kk) for i in _res(pr, s // pc, nb)
                       for kk in _res(pc, s % pc, nb)),
            size=nb * nb),
        writes=lambda i, kk: ("A", i, kk),
        reads=lambda i, kk: [("A", i, kk)],          # identity "send" body
        after=(lambda i, kk: [("sa", i, kk - 1)] if kk else [])
        if staged else None)
    g.task_type(
        "sb",
        space=IndexSpace(
            lambda: ((kk, j) for kk in range(nb) for j in range(nb)),
            lambda s: ((kk, j) for kk in _res(pr, s // pc, nb)
                       for j in _res(pc, s % pc, nb)),
            size=nb * nb),
        writes=lambda kk, j: ("B", kk, j),
        reads=lambda kk, j: [("B", kk, j)],
        after=(lambda kk, j: [("sb", kk - 1, j)] if kk else [])
        if staged else None)
    g.task_type(
        "gemm",
        space=IndexSpace(
            lambda: ((i, kk, j) for i in range(nb)
                     for kk in range(nb) for j in range(nb)),
            lambda s: ((i, kk, j) for i in _res(pr, s // pc, nb)
                       for kk in range(nb) for j in _res(pc, s % pc, nb)),
            size=nb ** 3),
        writes=lambda i, kk, j: ("C", i, j),         # RMW => k-chain derived
        reads=lambda i, kk, j: [("C", i, j), ("A", i, kk), ("B", kk, j)])
    return g


def gemm_2d_spec(nb: int, pr: int, pc: int, b: int, *, staged: bool = False,
                 dtype=torch.float32, lazy: bool = True) -> BlockPTGSpec:
    """Spec via lazy per-shard derivation by default; ``lazy=False`` is the
    eager global-scan oracle (identical program either way)."""
    return gemm_2d_graph(nb, pr, pc, b, staged=staged,
                         dtype=dtype).to_block_spec(lazy=lazy)


# ------------------------------------------------------------- 3D mapping

def gemm_3d_graph(nb: int, q: int, b: int, *, dtype=torch.float32) -> Graph:
    """DNS mapping on a q×q×q grid: slab l owns k in [l·nb/q, (l+1)·nb/q)."""
    assert nb % q == 0, "nb must divide into q slabs"
    kb = nb // q  # blocks per slab

    def shard(l, r, c) -> int:
        return l * q * q + (r % q) * q + (c % q)

    def slab(kk: int) -> int:
        return kk // kb

    def owner(blk) -> int:
        kind = blk[0]
        if kind == "A":
            _, i, kk = blk
            return shard(slab(kk), i, kk)
        if kind == "B":
            _, kk, j = blk
            return shard(slab(kk), kk, j)
        if kind in ("P", "Pf"):                  # partial C per slab
            _, i, j, l = blk
            return shard(l, i, j)
        _, i, j = blk                            # final C on slab 0
        return shard(0, i, j)

    g = Graph("gemm3d", n_shards=q ** 3, owner=owner,
              block_shape=(b, b), dtype=dtype)

    def grid(s):
        """Shard id -> (slab, row residue, col residue)."""
        return s // (q * q), (s // q) % q, s % q

    def slab_ks(l: int, r: int):
        """k indices inside slab l congruent to r mod q."""
        lo = l * kb
        return range(lo + (r - lo) % q, lo + kb, q)

    g.task_type(
        "sa",
        space=IndexSpace(
            lambda: ((i, kk) for i in range(nb) for kk in range(nb)),
            lambda s: ((i, kk) for i in _res(q, grid(s)[1], nb)
                       for kk in slab_ks(grid(s)[0], grid(s)[2])),
            size=nb * nb),
        writes=lambda i, kk: ("A", i, kk),
        reads=lambda i, kk: [("A", i, kk)])
    g.task_type(
        "sb",
        space=IndexSpace(
            lambda: ((kk, j) for kk in range(nb) for j in range(nb)),
            lambda s: ((kk, j) for kk in slab_ks(grid(s)[0], grid(s)[1])
                       for j in _res(q, grid(s)[2], nb)),
            size=nb * nb),
        writes=lambda kk, j: ("B", kk, j),
        reads=lambda kk, j: [("B", kk, j)])
    g.task_type(
        "gemm",                                  # slab-local k-chain on P
        space=IndexSpace(
            lambda: ((i, kk, j) for i in range(nb)
                     for kk in range(nb) for j in range(nb)),
            lambda s: ((i, kk, j) for i in _res(q, grid(s)[1], nb)
                       for kk in range(grid(s)[0] * kb,
                                       (grid(s)[0] + 1) * kb)
                       for j in _res(q, grid(s)[2], nb)),
            size=nb ** 3),
        writes=lambda i, kk, j: ("P", i, j, slab(kk)),
        reads=lambda i, kk, j: [("P", i, j, slab(kk)),
                                ("A", i, kk), ("B", kk, j)])
    g.task_type(
        "fin",                                   # close the slab's partial
        space=IndexSpace(
            lambda: ((i, j, l) for i in range(nb)
                     for j in range(nb) for l in range(q)),
            lambda s: ((i, j, grid(s)[0]) for i in _res(q, grid(s)[1], nb)
                       for j in _res(q, grid(s)[2], nb)),
            size=nb * nb * q),
        writes=lambda i, j, l: ("Pf", i, j, l),
        reads=lambda i, j, l: [("P", i, j, l)])
    g.task_type(
        "red",                                   # C += Pf_l reduction chain
        space=IndexSpace(
            lambda: ((i, j, l) for i in range(nb)
                     for j in range(nb) for l in range(q)),
            lambda s: (((i, j, l) for i in _res(q, grid(s)[1], nb)
                        for j in _res(q, grid(s)[2], nb) for l in range(q))
                       if grid(s)[0] == 0 else iter(())),
            size=nb * nb * q),
        writes=lambda i, j, l: ("C", i, j),
        reads=lambda i, j, l: [("C", i, j), ("Pf", i, j, l)])
    return g


def gemm_3d_spec(nb: int, q: int, b: int, *, dtype=torch.float32,
                 lazy: bool = True) -> BlockPTGSpec:
    return gemm_3d_graph(nb, q, b, dtype=dtype).to_block_spec(lazy=lazy)


# --------------------------------------------------- program + executor

def gemm_2d_program(nb: int, pr: int, pc: int, b: int, *,
                    staged: bool = False, dtype=torch.float32) -> BlockProgram:
    """Discover + lower the 2D GEMM PTG onto the shared comm-planning layer
    (classified per-wavefront patterns, dense and sparse exchange tables)."""
    return build_block_program(
        gemm_2d_spec(nb, pr, pc, b, staged=staged, dtype=dtype))


def gemm_3d_program(nb: int, q: int, b: int, *, dtype=torch.float32
                    ) -> BlockProgram:
    return build_block_program(gemm_3d_spec(nb, q, b, dtype=dtype))


def gemm_executor(prog: BlockProgram, *, matmul=None, device="cuda",
                  unroll_cap: int = 64, group=None,
                  **policy) -> BlockExecutor:
    """Sparsity-aware GEMM executor on ``device``. The eager 2D mapping's
    wavefront-0 broadcast is dense (all_to_all); the staged variant's per-k
    panel sends are sparse (ppermute rounds) and land after the k-1 rank
    updates that do not need them. ``policy`` kwargs (``comm``/``overlap``/
    ``segment_cap``/``density_threshold``) pass through to
    ``BlockProgram.auto_executor``; past ``unroll_cap`` deep staged
    schedules keep their sparse per-k sends via the segmented scan.
    ``group`` runs it on this process's rank of a process group of one
    rank per shard, on the rank's own row (``prog.pack_shard``)."""
    return prog.auto_executor(gemm_bodies(matmul), device=device,
                              unroll_cap=unroll_cap, group=group, **policy)


def gemm_rank(rank: int, world: int, nb: int, b: int, runs, *, device,
              pr: int = 2, pc: int = 2, staged: bool = False,
              q: Optional[int] = None, seed: int = 0, kernel: bool = False,
              on_device: bool = False, keep=None) -> list:
    """One rank's part of a GEMM over a process group of one rank per
    shard (``dist.ranks.spawn_ranks`` names it): the 2D program on a
    ``pr x pc`` grid (``staged`` or not), or with ``q`` the 3D one on a
    ``q x q x q`` grid; blocks from ``seed`` (:func:`make_blocks`, on
    ``device`` with ``on_device``); ``runs`` on the rank's shard with B1
    on the gemm updates where ``kernel`` (see ``dist.ranks.run_program``,
    which gives what it returns)."""
    prog = (gemm_3d_program(nb, q, b) if q else
            gemm_2d_program(nb, pr, pc, b, staged=staged))
    blocks = make_blocks(None, nb, b, seed=seed,
                         with_partials=tuple(range(q or 0)),
                         device=device if on_device else None)
    bodies = gemm_bodies(task_matmul if kernel else None)
    return run_program(prog, bodies, blocks, runs, device=device, keep=keep)


# ------------------------------------------------------------ bodies/oracle

def gemm_bodies(matmul=None) -> Dict[str, object]:
    """Batched compute bodies (each operand ``[N, b, b]``); ``matmul`` is
    pluggable: plain ``a @ b`` by default, or the kernel's
    ``repro_torch.kernels.block_gemm.ops.task_matmul``."""
    mm = matmul if matmul is not None else lambda a, b: a @ b

    return {
        "sa": lambda a: a,
        "sb": lambda b_: b_,
        "gemm": lambda c, a, b_: c + mm(a, b_),
        "fin": lambda p: p,
        "red": lambda c, pf: c + pf,
    }


def make_blocks(key, nb: int, b: int, *, with_partials: Tuple[int, ...] = (),
                seed: int = 0, device=None) -> Dict[Tuple, object]:
    """Random A/B blocks, zero C blocks (and zero 3D partials if requested),
    from numpy's generator as in the JAX package (``key`` is unused there
    too, kept for the same signature).

    With ``device`` the blocks are made by PyTorch on that device: A and
    then B drawn whole from a ``torch.Generator`` seeded with ``seed``
    (the blocks are views of them), so nothing passes through the host.
    The two forms draw different numbers."""
    if device is not None:
        n = nb * b
        gen = torch.Generator(device=device).manual_seed(seed)
        a = torch.randn((n, n), generator=gen, device=device)
        b_ = torch.randn((n, n), generator=gen, device=device)
        out: Dict[Tuple, object] = {}
        for i in range(nb):
            for j in range(nb):
                tile = (slice(i * b, (i + 1) * b), slice(j * b, (j + 1) * b))
                out[("A", i, j)] = a[tile]
                out[("B", i, j)] = b_[tile]
                out[("C", i, j)] = torch.zeros((b, b), device=device)
                for l in with_partials:
                    out[("P", i, j, l)] = torch.zeros((b, b), device=device)
        return out
    rng = np.random.default_rng(seed)
    blocks: Dict[Tuple, np.ndarray] = {}
    for i in range(nb):
        for j in range(nb):
            blocks[("A", i, j)] = rng.standard_normal((b, b)).astype(np.float32)
            blocks[("B", i, j)] = rng.standard_normal((b, b)).astype(np.float32)
            blocks[("C", i, j)] = np.zeros((b, b), np.float32)
            for l in with_partials:
                blocks[("P", i, j, l)] = np.zeros((b, b), np.float32)
    return blocks


def assemble(blocks: Dict[Tuple, object], kind: str, nb: int,
             b: int) -> torch.Tensor:
    """The ``nb·b`` square matrix of ``kind`` blocks, as a tensor on the
    blocks' device (numpy blocks assemble on the CPU)."""
    first = torch.as_tensor(blocks[(kind, 0, 0)])
    out = torch.zeros((nb * b, nb * b), dtype=first.dtype,
                      device=first.device)
    for i in range(nb):
        for j in range(nb):
            out[i * b:(i + 1) * b, j * b:(j + 1) * b] = torch.as_tensor(
                blocks[(kind, i, j)])
    return out
