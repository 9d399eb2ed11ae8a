"""Blocked Cholesky, the paper's Sec. III-C application (Fig 8's PTG),
through ``repro_torch``'s default executor with B1 on syrk and gemm.

The harness makes each SPD matrix itself, on the card, from a seed; the
program gets its lower blocks (``prog.pack``); the plain reference gets the
same matrix. A step factors one packed store into L.
"""

from __future__ import annotations

import torch

from repro_torch.linalg.cholesky import cholesky_executor, cholesky_program

from portbench.yardstick import gemm_task


def build(cfg: dict):
    return cholesky_program(cfg["nb"], *cfg["grid"], cfg["b"])


def make_input(cfg: dict, seed: int, device) -> dict:
    """``a = m mᵀ / n + 2 I`` with ``m`` standard normal from ``seed``:
    eigenvalues in about [2, 6]."""
    n = cfg["N"]
    gen = torch.Generator(device=device).manual_seed(seed)
    m = torch.randn((n, n), generator=gen, dtype=torch.float32,
                    device=device)
    a = torch.matmul(m, m.mT).div_(n)
    del m
    a.diagonal().add_(2.0)
    return {"a": a}


def blocks(cfg: dict, inp: dict) -> dict:
    b, nb, a = cfg["b"], cfg["nb"], inp["a"]
    return {("A", i, j): a[i * b:(i + 1) * b, j * b:(j + 1) * b]
            for i in range(nb) for j in range(i + 1)}


def executor(prog, matmul, device, group=None):
    return cholesky_executor(prog, matmul=matmul, device=device, group=group)


def result_blocks(cfg: dict) -> list:
    """The blocks of L, as ``(block id, (block row, block column))``."""
    nb = cfg["nb"]
    return [(("L", i, k), (i, k)) for i in range(nb) for k in range(i + 1)]


def real_tasks(cfg: dict) -> dict:
    """The GEMM-type tasks of one factorization: a syrk for each block
    below the diagonal's panel step, a gemm for each strictly lower pair."""
    nb = cfg["nb"]
    return {"syrk": nb * (nb - 1) // 2,
            "gemm": nb * (nb - 1) * (nb - 2) // 6}


def task_cost(cfg: dict) -> dict:
    """(flops, bytes) of one real task of each GEMM-type: syrk reads A_ii
    and L_ik, gemm A_ij, L_ik and L_jk; each writes one block."""
    b = cfg["b"]
    return {"syrk": gemm_task(b, b, b, 2), "gemm": gemm_task(b, b, b, 3)}


def flops(cfg: dict) -> float:
    """Useful operations of one factorization: N³/3."""
    return cfg["N"] ** 3 / 3.0


def reference(cfg: dict, inp: dict, ref, **kw) -> torch.Tensor:
    return ref.solve(inp["a"], cfg["b"], **kw)
