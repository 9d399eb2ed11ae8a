"""GQA flash attention, forward, causal or full, with an optional sliding
window: the body of the attention-chain PTG and the models' prefill
attention (the port of the JAX package's Pallas ``flash_attention``)."""

from .flash_attention import flash_attention
from .ops import attention, task_attention
from .ref import mha_bf16_p_ref, mha_ref

__all__ = ["attention", "flash_attention", "mha_bf16_p_ref", "mha_ref",
           "task_attention"]
