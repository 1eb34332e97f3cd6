"""Unified model/architecture configuration.

One dataclass covers all ten assigned architectures; family-specific fields
are ignored by families that do not use them.  Every arch file in
``repro_torch.configs`` exports ``CONFIG`` (the exact published shape) and
``smoke_config()`` (a reduced same-family shape for CPU tests).
``ShapeConfig``/``SHAPES`` are the assigned input-shape cells (sequence
length, global batch, kind), the reference's field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    act: str = "swiglu"               # swiglu | geglu | gelu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma-style sqrt(d) embedding scaling
    # --- attention pattern ----------------------------------------------
    sliding_window: Optional[int] = None   # local layers' window
    local_global_ratio: int = 0            # N local : 1 global (0 = all global)
    # --- MoE --------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False      # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- SSM / hybrid ------------------------------------------------------
    ssm_state: int = 0                # mamba2 state dim
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    attn_every: int = 0               # zamba: shared attn block period
    rwkv: bool = False
    # --- encoder-decoder / frontends ----------------------------------------
    n_enc_layers: int = 0
    frontend: Optional[str] = None    # "audio_frames" | "vision_patches"
    n_frontend_tokens: int = 0        # patches/frames supplied by the stub
    cross_kv_len: int = 1500          # whisper encoder output length
    # --- numerics ----------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.rwkv

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (see DESIGN.md skip table)."""
        return (
            self.rwkv
            or self.ssm_state > 0
            or (self.sliding_window is not None and self.local_global_ratio > 0)
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        if self.act in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        per_layer = attn + mlp
        if self.n_experts:
            per_layer = attn + self.n_experts * 3 * d * self.moe_d_ff
            if self.dense_residual:
                per_layer += 3 * d * self.d_ff
        if self.ssm_state:
            # mamba2-ish: in_proj + out_proj dominate
            din = self.ssm_heads * self.ssm_head_dim
            per_layer = d * (2 * din + 2 * self.ssm_state + self.ssm_heads) + din * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = self.n_layers * per_layer + emb
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn + mlp)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k active experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        attn = d * self.n_heads * self.hd * 2 + d * self.n_kv_heads * self.hd * 2
        per_layer = attn + self.top_k * 3 * d * self.moe_d_ff
        if self.dense_residual:
            per_layer += 3 * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(self.n_layers * per_layer + emb)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
