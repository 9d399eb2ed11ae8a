"""deepseek-v3-671b [moe]: 61L d_model=7168 128H (MLA) vocab=129280,
MoE 1 shared + 256 routed top-8 (expert d_ff=2048), first 3 layers dense
(d_ff=18432), aux-loss-free sigmoid router [arXiv:2412.19437; hf].

MTP head omitted (DESIGN.md §Arch-applicability). Trains with Adafactor —
full-Adam mixed precision at 14 B/param does not fit 256 x 16 GB.
"""

from .base import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
        n_heads=128, n_kv_heads=128, d_ff=18432, vocab_size=129280,
        ffn="swiglu", attention="mla",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, experts_per_token=8, n_shared_experts=1,
                      d_ff=2048, first_dense_layers=3, router="sigmoid"),
        optimizer="adafactor", param_dtype="bfloat16")
