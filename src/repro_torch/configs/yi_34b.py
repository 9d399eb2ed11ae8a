"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
— llama-arch GQA [arXiv:2403.04652; hf]."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_head=128, d_ff=20480, vocab_size=64000,
        ffn="swiglu", rope_theta=5e6)
