"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling; the modality frontend is a STUB
(input_specs() provides precomputed anyres patch embeddings)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, d_head=128, d_ff=20480, vocab_size=64000,
        ffn="swiglu", rope_theta=5e6, embed_inputs=True)
