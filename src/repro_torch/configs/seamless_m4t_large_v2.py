"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206 — enc-dec; the audio frontend is a STUB (input_specs()
provides precomputed frame embeddings) [arXiv:2308.11596; hf]."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec", n_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=16, d_head=64, d_ff=8192,
        vocab_size=256206, ffn="swiglu", encoder_layers=24,
        embed_inputs=True)
