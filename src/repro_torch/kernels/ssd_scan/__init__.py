"""Mamba-2 SSD chunked scan: the sequence mixer of the mamba2 block (the
port of the JAX package's Pallas ``ssd_scan``)."""

from .ops import ssd
from .ref import ssd_bf16_operands_ref, ssd_chunked_ref, ssd_ref
from .ssd_scan import ssd_scan

__all__ = ["ssd", "ssd_bf16_operands_ref", "ssd_chunked_ref", "ssd_ref",
           "ssd_scan"]
