"""Plain blocked Cholesky in PyTorch: what the port's factor is held to.

Right-looking, one panel of ``b`` columns at a time: the diagonal block by
``torch.linalg.cholesky``, the panel below it by a triangular solve, the
trailing matrix by one product. In float64 it is the reference; with
``tf32`` its trailing products take operands rounded to TF32, the control
that a check must refuse (a later change that let the updates run on the
tensor cores would compute so). Imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.yardstick import to_tf32


def solve(a: torch.Tensor, b: int, *, dtype=torch.float64,
          tf32: bool = False) -> torch.Tensor:
    """The lower Cholesky factor of the SPD matrix ``a``, in ``dtype``."""
    if tf32 and dtype != torch.float32:
        raise ValueError("the TF32 control computes in float32")
    n = a.shape[0]
    l = a.to(dtype=dtype, copy=True)
    for k0 in range(0, n, b):
        k1 = min(k0 + b, n)
        l[k0:k1, k0:k1] = torch.linalg.cholesky(l[k0:k1, k0:k1])
        if k1 == n:
            break
        panel = torch.linalg.solve_triangular(
            l[k0:k1, k0:k1], l[k1:, k0:k1].mT, upper=False).mT
        l[k1:, k0:k1] = panel
        p = to_tf32(panel) if tf32 else panel
        l[k1:, k1:] -= p @ p.mT
    return l.tril_()
