"""Public form of the SSD scan: ``ssd``, as the model calls it."""

from __future__ import annotations

from typing import Optional

import torch

from .._build import needs_grad
from .ssd_scan import plain, ssd_scan


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, d: Optional[torch.Tensor] = None, *,
        q_chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD. On CUDA tensors the chunked kernel (it masks a ragged
    last chunk); on CPU tensors, and under grad on any device (the kernel
    has no backward), the JAX package's off-TPU rule, its training path:
    the chunked plain version when L tiles, else the token recurrence. On
    the meta device (the dry run's trace) that plain version too."""
    if needs_grad(x, dt, a, b, c, d) or x.device.type == "meta":
        return plain(x, dt, a, b, c, d, q_chunk)
    return ssd_scan(x, dt, a, b, c, d, q_chunk=q_chunk)
