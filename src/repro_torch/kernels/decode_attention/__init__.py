"""Single-token GQA decode attention over a KV cache (the port of the JAX
package's Pallas ``decode_attention``)."""

from .decode_attention import decode_attention, kernel_info
from .ops import decode
from .ref import decode_bf16_p_ref, decode_ref

__all__ = ["decode", "decode_attention", "decode_bf16_p_ref", "decode_ref",
           "kernel_info"]
