"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1; unverified].

Trains with Adafactor (giant-arch memory policy, DESIGN.md)."""

from .base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
        n_heads=48, n_kv_heads=8, d_head=128, d_ff=32768, vocab_size=131072,
        ffn="gelu",
        moe=MoEConfig(n_experts=8, experts_per_token=2, d_ff=32768),
        optimizer="adafactor", param_dtype="bfloat16")
