"""Distributed blocked Cholesky as a declarative PTG — the paper's §III-C
flagship app, declared once through the ``repro_torch.ptg`` front-end.

Right-looking variant of Algorithm 1, in the PTG form of Fig 8:

    potrf(k):        L_kk   = chol(A_kk)
    trsm(i,k):       L_ik   = A_ik · L_kk^{-T}                (i > k)
    syrk(k,i):       A_ii  -= L_ik · L_ikᵀ                    (i > k)
    gemm(k,i,j):     A_ij  -= L_ik · L_jkᵀ                    (i > j > k)

Each task type declares only the blocks it reads and the block it writes;
the whole dependency web of Fig 8 — panel broadcasts, trailing-update
chains, the syrk→potrf hand-off down the diagonal — is *derived* by the
builder from those access patterns over the factorization's sequential
program order (``Graph.sequence``), with in/out edges mutual inverses by
construction.

Blocks are 2D block-cyclic on a pr×pc grid. Factor blocks L_ik get fresh
block ids (single assignment) because they cross shards: potrf/trsm results
are exactly the payloads the paper ships via (large) active messages, while
the A_ij update accumulations stay owner-local (read-modify-write).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import (BlockExecutor, BlockProgram,
                                       BlockPTGSpec, build_block_program)
from repro_torch.ptg import Graph, IndexSpace


def cholesky_graph(nb: int, pr: int, pc: int, b: int,
                   dtype=torch.float32) -> Graph:
    def owner(blk) -> int:
        _, i, j = blk
        return (i % pr) * pc + (j % pc)

    g = Graph("cholesky", n_shards=pr * pc, owner=owner,
              block_shape=(b, b), dtype=dtype)
    g.task_type("potrf",
                writes=lambda k: ("L", k, k),
                reads=lambda k: [("A", k, k)])
    g.task_type("trsm",
                writes=lambda i, k: ("L", i, k),
                reads=lambda i, k: [("A", i, k), ("L", k, k)])
    g.task_type("syrk",
                writes=lambda k, i: ("A", i, i),
                reads=lambda k, i: [("A", i, i), ("L", i, k)])
    g.task_type("gemm",
                writes=lambda k, i, j: ("A", i, j),
                reads=lambda k, i, j: [("A", i, j), ("L", i, k), ("L", j, k)])

    def program():
        # the right-looking factorization's sequential order: the access
        # scan over this order reproduces Fig 8's PTG edge-for-edge
        for k in range(nb):
            yield ("potrf", k)
            for i in range(k + 1, nb):
                yield ("trsm", i, k)
            for i in range(k + 1, nb):
                yield ("syrk", k, i)
            for i in range(k + 1, nb):
                for j in range(k + 1, i):
                    yield ("gemm", k, i, j)

    def res(lo: int, hi: int, p: int, r: int):
        """Indices in [lo, hi) congruent to r mod p."""
        return range(lo + (r - lo) % p, hi, p)

    def owned(shard):
        # the triangular space partitions by block-cyclic residue: each
        # task type's written block fixes a (row mod pr, col mod pc)
        # residue class, so the shard walks only its own rows/columns —
        # O(owned) instead of the O(nb³) full triangle
        r0, c0 = divmod(shard, pc)
        for k in range(nb):
            if k % pr == r0 and k % pc == c0:
                yield ("potrf", k)                       # writes L_kk
            if k % pc == c0:
                for i in res(k + 1, nb, pr, r0):
                    yield ("trsm", i, k)                 # writes L_ik
            for i in res(k + 1, nb, pr, r0):
                if i % pc == c0:
                    yield ("syrk", k, i)                 # writes A_ii
            for i in res(k + 1, nb, pr, r0):
                for j in res(k + 1, i, pc, c0):
                    yield ("gemm", k, i, j)              # writes A_ij

    n_tasks = (nb + 2 * (nb * (nb - 1) // 2)
               + nb * (nb - 1) * (nb - 2) // 6)
    g.sequence(IndexSpace(program, owned, size=n_tasks))
    return g


def cholesky_spec(nb: int, pr: int, pc: int, b: int,
                  dtype=torch.float32, *, lazy: bool = True) -> BlockPTGSpec:
    """Spec via lazy per-shard derivation by default; ``lazy=False`` is the
    eager global-scan oracle (identical program either way)."""
    return cholesky_graph(nb, pr, pc, b, dtype=dtype).to_block_spec(lazy=lazy)


def cholesky_program(nb: int, pr: int, pc: int, b: int,
                     dtype=torch.float32) -> BlockProgram:
    """Discover + lower the Cholesky PTG onto the shared comm-planning
    layer. Its panel broadcasts (potrf -> column trsms, trsm -> trailing
    updates) activate only O(grid) of the n² shard pairs per wavefront, so
    the classified plan lowers them to ppermute rounds, which carry far
    less padding than the dense all_to_all (see comm_stats)."""
    return build_block_program(cholesky_spec(nb, pr, pc, b, dtype=dtype))


def cholesky_executor(prog: BlockProgram, *, matmul=None, trsm=None,
                      device="cuda", unroll_cap: int = 64,
                      **policy) -> BlockExecutor:
    """Sparsity-aware Cholesky executor on ``device``, with the overlap
    order of the paper's Fig 9: wavefront w's panel broadcast is gathered
    before w+1's halo-independent trailing updates (owner-local A_ij
    accumulations) run, and lands before the halo-dependent ones.
    ``policy`` kwargs (``comm``/``overlap``/``segment_cap``/
    ``density_threshold``) pass through to ``auto_executor``, whose ladder
    is: unrolled below ``unroll_cap``; segmented scan when the exact comm
    signatures form few runs; **union-cover scan** when they fragment (deep
    Cholesky's panel broadcasts change shape every panel) but the union
    permutation cover's wire still beats the dense scan's; the pure dense
    scan only as the loudly-reported last resort. ``matmul``/``trsm`` are
    pluggable bodies — pass ``repro_torch.kernels.block_gemm.ops
    .task_matmul`` to run the trailing updates through the CUDA kernel, one
    launch per wavefront and type (the plain default stays the oracle)."""
    return prog.auto_executor(cholesky_bodies(matmul, trsm), device=device,
                              unroll_cap=unroll_cap, **policy)


def cholesky_bodies(matmul=None, trsm=None) -> Dict[str, object]:
    """Bodies on batched ``[N, b, b]`` operands (the block executor's) or
    on single ``[b, b]`` blocks (the host runtime's); ``matmul``/``trsm``
    pluggable, plain ``a @ b`` by default. On the host runtime pass
    ``kernels.block_gemm.ops.matmul`` to run syrk and gemm through B1, one
    launch per task. potrf and trsm are library calls,
    as in the JAX package. potrf uses ``cholesky_ex`` without its error
    check: padded tasks factor the trash slot, which is not positive
    definite, and must not raise (their garbage stays in trash)."""
    mm = matmul if matmul is not None else lambda a, b: a @ b

    def _trsm(a, l_kk):
        # Solve X · L_kkᵀ = A_ik  =>  X = (L_kk^{-1} · A_ikᵀ)ᵀ
        return torch.linalg.solve_triangular(l_kk, a.mT, upper=False).mT

    return {
        "potrf": lambda a: torch.linalg.cholesky_ex(a)[0],
        "trsm": trsm if trsm is not None else _trsm,
        "syrk": lambda a, l: a - mm(l, l.mT),
        "gemm": lambda a, li, lj: a - mm(li, lj.mT),
    }


def cholesky_bodies_numpy() -> Dict[str, object]:
    """Fork-safe host bodies that compute with numpy/scipy on CPU tensor
    blocks and return CPU tensors (``torch.from_numpy``: no copy, numpy's
    strides kept, so every later product sees the layout the JAX package's
    numpy bodies see). The
    ``multiproc`` transport forks one process per rank, where CUDA cannot
    run and torch's own CPU kernels could meet an OpenMP pool inherited
    from the parent, so cross-process runs use these. They run the same
    numpy arithmetic as the JAX package's ``cholesky_bodies_numpy``, so
    the two agree bit for bit on the same blocks."""
    import scipy.linalg as sla

    def wrap(fn):
        return lambda *ops: torch.from_numpy(fn(*(o.numpy() for o in ops)))

    def _trsm(a, l_kk):
        return sla.solve_triangular(l_kk, a.T, lower=True, trans="N").T

    return {
        "potrf": wrap(lambda a: np.linalg.cholesky(a)),
        "trsm": wrap(_trsm),
        "syrk": wrap(lambda a, l: a - l @ l.T),
        "gemm": wrap(lambda a, li, lj: a - li @ lj.T),
    }


def make_spd_blocks(nb: int, b: int, seed: int = 0, *, device=None,
                    generator: Optional[torch.Generator] = None):
    """Random SPD matrix ``a = m mᵀ / n + 2 I`` and its lower-triangle
    blocks ``{("A", i, j)}``; returns ``(blocks, a)``.

    By default the matrix is made with numpy from ``seed``, exactly as the
    JAX package makes it. With ``device`` (or ``generator``) it is made by
    PyTorch on that device from a ``torch.Generator`` (``generator``, else
    one seeded with ``seed``), and the blocks are views of ``a`` there: at
    paper scale the host product ``m mᵀ`` takes minutes, and the matrix
    never passes through the host. The two forms draw different numbers."""
    n = nb * b
    if device is None and generator is None:
        rng = np.random.default_rng(seed)
        m = rng.standard_normal((n, n)).astype(np.float32)
        a = (m @ m.T) / n + np.eye(n, dtype=np.float32) * 2.0
        blocks: Dict[Tuple, object] = {
            ("A", i, j): a[i * b:(i + 1) * b, j * b:(j + 1) * b].copy()
            for i in range(nb) for j in range(i + 1)}
        return blocks, a
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    device = generator.device if device is None else torch.device(device)
    m = torch.randn((n, n), generator=generator, dtype=torch.float32,
                    device=device)
    a = torch.matmul(m, m.mT) / n
    a.diagonal().add_(2.0)
    del m
    blocks = {("A", i, j): a[i * b:(i + 1) * b, j * b:(j + 1) * b]
              for i in range(nb) for j in range(i + 1)}
    return blocks, a


def assemble_lower(blocks: Dict[Tuple, object], nb: int,
                   b: int) -> torch.Tensor:
    """Assemble L from ("L", i, k) blocks (strict upper zeroed), as a tensor
    on the blocks' device (numpy blocks assemble on the CPU)."""
    first = torch.as_tensor(blocks[("L", 0, 0)])
    out = torch.zeros((nb * b, nb * b), dtype=first.dtype,
                      device=first.device)
    for i in range(nb):
        for k in range(i + 1):
            blk = blocks.get(("L", i, k))
            if blk is not None:
                out[i * b:(i + 1) * b, k * b:(k + 1) * b] = torch.as_tensor(blk)
    return out.tril_()
