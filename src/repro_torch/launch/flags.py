"""Launch-time flags threaded to model internals via environment variables.

The port's own copy of the readers in ``repro.launch.flags``.
``REPRO_REMAT`` picks the activation checkpointing of the layer loops
(``torch.utils.checkpoint`` in ``models/transformer.py``). The JAX
package's ``REPRO_UNROLL_SCANS`` unrolls its ``lax.scan`` loops for XLA's
cost analysis; the port's loops are Python loops, so its two readers steer
nothing here and stay for parity.
"""

import os


def unroll_scans() -> bool:
    """REPRO_UNROLL_SCANS=1: the JAX package unrolls every ``lax.scan``. The
    port has no scan to unroll; kept as a reader for parity."""
    return os.environ.get("REPRO_UNROLL_SCANS", "0") == "1"


def scan_unroll_arg():
    """The ``unroll=`` argument the JAX package passes ``lax.scan`` (True
    when unrolled, else 1). Nothing in the port reads it; kept for
    parity."""
    return True if unroll_scans() else 1


def remat_policy() -> str:
    """REPRO_REMAT: none | full | dots, the activation-checkpoint policy of
    the layer loops under grad (default full)."""
    return os.environ.get("REPRO_REMAT", "full")


def ssd_chunk():
    """REPRO_SSD_CHUNK: the SSD scan's chunk length Q (None: the default
    128)."""
    v = os.environ.get("REPRO_SSD_CHUNK")
    return int(v) if v else None


def attn_chunk():
    """REPRO_ATTN_CHUNK: the KV chunk of ``chunked_attention`` (None: the
    default 1024)."""
    v = os.environ.get("REPRO_ATTN_CHUNK")
    return int(v) if v else None


def moe_capacity_factor():
    """REPRO_MOE_CF: the MoE capacity factor (None: the config's). Both
    packages' ``moe_ffn`` read it."""
    v = os.environ.get("REPRO_MOE_CF")
    return float(v) if v else None
