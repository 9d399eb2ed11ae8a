"""mamba2-1.3b [ssm]: 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]."""

from .base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
        n_heads=0, n_kv_heads=0, d_head=64, d_ff=0, vocab_size=50280,
        attention="none", tie_embeddings=True, subquadratic=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1))
