"""Task-Bench's dependence-pattern sweep (Slaughter et al., 1908.05790) as
a block PTG: the graph, spec, bodies, blocks and sequential oracle of the
JAX package's ``benchmarks/taskbench_scaling.py``, ported so that the
port's tests and benchmarks need not import that JAX benchmark.

Task Bench parametrizes a runtime by its *dependence pattern*: the same
layered task grid is rerun under stencil / FFT / tree / random edges. Each
pattern goes through the pipeline every app uses (``taskbench_spec`` ->
discovery -> ``build_block_program`` -> ``auto_executor``). It stresses
sparse exchange rounds more than Cholesky does. Its bodies are elementwise,
so no kernel runs here.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import BlockPTGSpec, build_block_program
from repro_torch.dist.ranks import run_program
from repro_torch.ptg import Graph, IndexSpace

PATTERNS = ("stencil", "fft", "tree", "random")


def pattern_parents(pattern: str, l: int, i: int, width: int, *,
                    fan: int = 3, seed: int = 0) -> List[int]:
    """Column indices in layer ``l - 1`` that task (l, i) consumes."""
    if pattern == "stencil":
        return [j for j in (i - 1, i, i + 1) if 0 <= j < width]
    if pattern == "fft":
        stride = 1 << ((l - 1) % max(width.bit_length() - 1, 1))
        return sorted({i, (i ^ stride) % width})
    if pattern == "tree":
        return sorted({(2 * i) % width, (2 * i + 1) % width})
    if pattern == "random":
        rng = np.random.default_rng((seed, l, i))
        k = min(fan, width)
        return sorted(int(j) for j in
                      rng.choice(width, size=k, replace=False))
    raise ValueError(f"unknown pattern {pattern!r}")


def taskbench_graph(pattern: str, width: int, depth: int, n_shards: int,
                    b: int = 8, *, fan: int = 3, seed: int = 0,
                    dtype=torch.float32) -> Tuple[Graph, Dict]:
    """Layered task grid as a declarative ``repro_torch.ptg`` graph: task (l, i)
    RMWs its own block and reads its parents' layer-(l-1) blocks — in/out
    edges, operands, and seeds all derive from those access patterns.
    Columns map to shards in contiguous chunks, so stencil comm stays
    neighbor-sparse while random comm approaches all-to-all — the two ends
    Task Bench sweeps. One task type per fan-in count (the block executor
    needs fixed arity per type); legacy (l, i) task keys are preserved via
    the ``key`` override."""
    deps: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for l in range(1, depth):
        for i in range(width):
            deps[(l, i)] = [(l - 1, j)
                            for j in pattern_parents(pattern, l, i, width,
                                                     fan=fan, seed=seed)]

    def owner(blk) -> int:
        return blk[1] * n_shards // width

    g = Graph(f"taskbench-{pattern}", n_shards=n_shards,
              owner=owner, block_shape=(b, b), dtype=dtype)
    for nfan in sorted({len(d) for d in deps.values()} | {0}):
        g.task_type(f"f{nfan}",
                    key=lambda l, i: (l, i),
                    writes=lambda l, i: (l, i),
                    reads=lambda l, i: [(l, i)] + deps.get((l, i), []))

    def entries():
        return ((f"f{len(deps.get((l, i), ()))}", l, i)
                for l in range(depth) for i in range(width))

    def owned(shard):
        # the width×depth grid partitions by column: shard s owns exactly
        # the columns whose blocks it owns — strip enumeration is O(owned)
        cols = [i for i in range(width) if i * n_shards // width == shard]
        return ((f"f{len(deps.get((l, i), ()))}", l, i)
                for l in range(depth) for i in cols)

    g.sequence(IndexSpace(entries, owned, size=depth * width))
    return g, deps


def taskbench_spec(pattern: str, width: int, depth: int, n_shards: int,
                   b: int = 8, *, fan: int = 3, seed: int = 0,
                   dtype=torch.float32, lazy: bool = True
                   ) -> Tuple[BlockPTGSpec, Dict]:
    g, deps = taskbench_graph(pattern, width, depth, n_shards, b,
                              fan=fan, seed=seed, dtype=dtype)
    return g.to_block_spec(lazy=lazy), deps


def taskbench_bodies(max_fan: int = 8) -> Dict[str, object]:
    """One body per fan-in: half the task's own block plus its parents'.
    Elementwise, so the same function serves one block or a batch."""
    def body(*ops):
        out = ops[0] * 0.5
        for o in ops[1:]:
            out = out + o
        return out

    return {f"f{k}": body for k in range(max_fan + 1)}


def taskbench_rank(rank: int, world: int, pattern: str, width: int,
                   depth: int, n_shards: int, b: int, runs, *, device,
                   fan: int = 3, seed: int = 0, keep=None) -> list:
    """One rank's part of a Task-Bench program over a process group of
    ``n_shards`` ranks (``dist.ranks.spawn_ranks`` names it): the program
    and blocks of ``pattern`` from ``seed``, ``runs`` on the rank's shard
    (see ``dist.ranks.run_program``, which gives what it returns)."""
    spec, _ = taskbench_spec(pattern, width, depth, n_shards, b, fan=fan,
                             seed=seed)
    return run_program(build_block_program(spec), taskbench_bodies(),
                       taskbench_blocks(width, depth, b, seed), runs,
                       device=device, keep=keep)


def taskbench_blocks(width: int, depth: int, b: int = 8,
                     seed: int = 0) -> Dict[Tuple[int, int], np.ndarray]:
    rng = np.random.default_rng(seed)
    return {(l, i): rng.standard_normal((b, b)).astype(np.float32)
            for l in range(depth) for i in range(width)}


def taskbench_oracle(blocks, deps, width: int, depth: int):
    """Sequential layer-by-layer reference (same arithmetic as the bodies)."""
    vals = {blk: arr.copy() for blk, arr in blocks.items()}
    for l in range(depth):
        layer = {}
        for i in range(width):
            out = vals[(l, i)] * 0.5
            for d in deps.get((l, i), []):
                out = out + vals[d]
            layer[(l, i)] = out
        vals.update(layer)
    return vals
