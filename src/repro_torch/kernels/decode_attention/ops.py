"""The model's form of the decode attention kernel.

``decode(q, k, v, kv_len=None)``: single-token GQA decode, q [B, Hq, D]
against k/v [B, Hkv, S, D], optional kv_len [B] -> [B, Hq, D]. It is the
wrapper itself (on CPU tensors the plain version). Unlike the JAX package's
``decode`` (``ops.py:12-18`` there), it does not fall back to the plain
version when S does not tile: the CUDA kernel masks a ragged cache.
"""

from __future__ import annotations

from .decode_attention import decode_attention

decode = decode_attention
