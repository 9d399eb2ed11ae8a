"""2D block-cyclic GEMM with staged sends, the paper's Sec. III-B
application (Fig 7), through ``repro_torch``'s default executor with B1 on
the gemm updates.

The harness makes each (A, B) pair itself, on the card, from a seed; the
program gets their blocks and zero C blocks (``prog.pack``); the plain
reference gets the same matrices. A step computes one C = A B.
"""

from __future__ import annotations

import torch

from repro_torch.linalg.gemm import gemm_2d_program, gemm_executor

from portbench.yardstick import gemm_task


def build(cfg: dict):
    return gemm_2d_program(cfg["nb"], *cfg["grid"], cfg["b"],
                           staged=cfg["staged"])


def make_input(cfg: dict, seed: int, device) -> dict:
    """A, then B, standard normal from ``seed``."""
    n = cfg["N"]
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((n, n), generator=gen, dtype=torch.float32,
                    device=device)
    b = torch.randn((n, n), generator=gen, dtype=torch.float32,
                    device=device)
    return {"a": a, "b": b}


def blocks(cfg: dict, inp: dict) -> dict:
    b, nb = cfg["b"], cfg["nb"]
    zero = torch.zeros((b, b), dtype=torch.float32, device=inp["a"].device)
    out = {}
    for i in range(nb):
        for j in range(nb):
            tile = (slice(i * b, (i + 1) * b), slice(j * b, (j + 1) * b))
            out[("A", i, j)] = inp["a"][tile]
            out[("B", i, j)] = inp["b"][tile]
            out[("C", i, j)] = zero
    return out


def executor(prog, matmul, device, group=None):
    return gemm_executor(prog, matmul=matmul, device=device, group=group)


def result_blocks(cfg: dict) -> list:
    """The blocks of C, as ``(block id, (block row, block column))``."""
    nb = cfg["nb"]
    return [(("C", i, j), (i, j)) for i in range(nb) for j in range(nb)]


def real_tasks(cfg: dict) -> dict:
    """One gemm task for each (i, k, j): nb³."""
    return {"gemm": cfg["nb"] ** 3}


def task_cost(cfg: dict) -> dict:
    """(flops, bytes) of one gemm task: reads C_ij, A_ik, B_kj, writes
    C_ij."""
    b = cfg["b"]
    return {"gemm": gemm_task(b, b, b, 3)}


def flops(cfg: dict) -> float:
    """Useful operations of one product: 2N³."""
    return 2.0 * cfg["N"] ** 3


def reference(cfg: dict, inp: dict, ref, **kw) -> torch.Tensor:
    return ref.solve(inp["a"], inp["b"], **kw)
