"""Plain matrix product in PyTorch: what the port's GEMM is held to.

In float64 it is the reference; with ``tf32`` both operands are rounded to
TF32 and multiplied in float32, the control that a check must refuse.
Imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.yardstick import to_tf32


def solve(a: torch.Tensor, b: torch.Tensor, *, dtype=torch.float64,
          tf32: bool = False) -> torch.Tensor:
    """``a @ b`` in ``dtype``."""
    if tf32:
        if dtype != torch.float32:
            raise ValueError("the TF32 control computes in float32")
        return to_tf32(a.float()) @ to_tf32(b.float())
    return a.to(dtype) @ b.to(dtype)
