"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3 MoE family; hf]."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, act="swiglu", qk_norm=True,
    n_experts=128, top_k=8, moe_d_ff=1536,
    rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=48, vocab=128, n_experts=8, top_k=2, moe_d_ff=48, capacity_factor=8.0,
        dtype="float32", remat=False)
