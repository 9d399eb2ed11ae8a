"""Public form of the SSD scan: ``ssd``, as the model calls it."""

from __future__ import annotations

from typing import Optional

import torch

from .ssd_scan import ssd_scan


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, d: Optional[torch.Tensor] = None, *,
        q_chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD. On CUDA tensors always the chunked kernel (it masks a
    ragged last chunk); on CPU tensors the JAX package's off-TPU rule: the
    chunked plain version when L tiles, else the token recurrence."""
    return ssd_scan(x, dt, a, b, c, d, q_chunk=q_chunk)
