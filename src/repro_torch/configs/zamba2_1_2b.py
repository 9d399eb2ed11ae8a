"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + one *shared* attention block
applied every 6 layers (zamba-style) [arXiv:2411.15242; hf].

Long-context: the shared attention block uses a sliding window at 500k, so
long_500k runs (subquadratic)."""

from .base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
        n_heads=32, n_kv_heads=32, d_head=64, d_ff=8192, vocab_size=32000,
        ffn="swiglu", tie_embeddings=True, subquadratic=True,
        sliding_window=4096, shared_attn_every=6,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      n_groups=1))
