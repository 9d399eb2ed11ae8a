"""Config system: one frozen dataclass per architecture + the shape cells.

Every assigned architecture gets a ``configs/<id>.py`` exposing ``config()``
with the exact published dimensions; ``reduced()`` returns the same family
shrunk for CPU smoke tests. Shape cells (train_4k / prefill_32k / decode_32k
/ long_500k) are global and filtered per-arch by the skip rules recorded in
DESIGN.md §Arch-applicability.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    n_shared_experts: int = 0
    d_ff: int = 0                     # per-expert hidden dim
    first_dense_layers: int = 0       # leading layers that stay dense
    router: str = "softmax"           # softmax | sigmoid (aux-free bias)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                   # 0 -> d_model // n_heads
    ffn: str = "swiglu"               # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attention: str = "gqa"            # gqa | mla | none
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba-style): one *shared* attention block applied every
    # `shared_attn_every` backbone layers
    shared_attn_every: int = 0
    # enc-dec
    encoder_layers: int = 0
    # frontends ([vlm]/[audio]): inputs arrive as precomputed embeddings
    embed_inputs: bool = False
    # long-context policy: True iff attention cost per decoded token is O(1)
    # (SSM state) or windowed — full-attention archs skip long_500k
    subquadratic: bool = False
    sliding_window: int = 0           # used by hybrid shared-attn at 500k
    # training knobs
    optimizer: str = "adamw"          # adamw | adafactor (giant archs)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, L = self.d_model, self.n_layers
        p = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attention == "gqa":
            hd = self.head_dim
            per_layer += d * hd * (self.n_heads + 2 * self.n_kv_heads)
            per_layer += self.n_heads * hd * d
        elif self.attention == "mla":
            m = self.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
            per_layer += d * (m.kv_lora_rank + m.qk_rope_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim
                                                          + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            nh = self.ssm.n_heads(d)
            g = self.ssm.n_groups
            per_layer_ssm = d * (2 * di + 2 * g * self.ssm.d_state + nh) + di * d
            per_layer = per_layer + per_layer_ssm if self.family == "hybrid" \
                else per_layer_ssm
        ff_mult = 3 if self.ffn == "swiglu" else 2
        if self.moe is not None:
            moe_layers = L - self.moe.first_dense_layers
            dense_layers = self.moe.first_dense_layers
            per_moe = (self.moe.n_experts + self.moe.n_shared_experts) \
                * ff_mult * d * self.moe.d_ff + d * self.moe.n_experts
            p += moe_layers * (per_layer + per_moe)
            p += dense_layers * (per_layer + ff_mult * d * self.d_ff)
        elif self.family in ("ssm",):
            p += L * per_layer
        elif self.family == "hybrid":
            p += L * per_layer_ssm
            hd = self.head_dim
            shared = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d + ff_mult * d * self.d_ff
            p += shared  # one shared block
        else:
            layers = L + self.encoder_layers
            p += layers * (per_layer + ff_mult * d * self.d_ff)
        return p

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        full = self.n_params()
        ff_mult = 3 if self.ffn == "swiglu" else 2
        moe_layers = L - self.moe.first_dense_layers
        all_experts = moe_layers * self.moe.n_experts * ff_mult * d * self.moe.d_ff
        active = moe_layers * self.moe.experts_per_token * ff_mult * d \
            * self.moe.d_ff
        return full - all_experts + active


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shapes_for(cfg: ModelConfig) -> List[ShapeCell]:
    """Skip rules (DESIGN.md §Arch-applicability): long_500k only for
    subquadratic archs; decode for every arch here (all have decoders)."""
    cells = []
    for cell in SHAPES:
        if cell.name == "long_500k" and not cfg.subquadratic:
            continue
        cells.append(cell)
    return cells


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config for CPU smoke tests, keeping the family intact."""
    small = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=32,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 8), d_ff=128,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
    if cfg.mla is not None:
        small["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                 qk_nope_dim=16, qk_rope_dim=16, v_head_dim=32)
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32)
    if cfg.encoder_layers:
        small["encoder_layers"] = 2
    if cfg.shared_attn_every:
        small["shared_attn_every"] = 2
        small["n_layers"] = 4
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
