"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, non-GLU MLP (d_ff = 4d) [arXiv:2402.19173; hf]."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
        n_heads=24, n_kv_heads=2, d_head=128, d_ff=12288, vocab_size=49152,
        ffn="gelu", rope_theta=1e5)
