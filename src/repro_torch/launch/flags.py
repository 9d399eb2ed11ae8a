"""Launch-time flags threaded to model internals via environment variables.

The port's own copy of the readers in ``repro.launch.flags`` that its
modules call. The JAX package's scan-unroll and remat flags steer
``lax.scan`` and ``jax.checkpoint``, which the port does not use.
"""

import os


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
