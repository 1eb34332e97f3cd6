"""arctic-480b [moe]: 35L d=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 PLUS a parallel dense residual FFN
[hf:Snowflake/snowflake-arctic-base; hf]."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, act="swiglu",
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=128, n_experts=8, top_k=2, moe_d_ff=48, capacity_factor=8.0,
        dtype="float32", remat=False)
