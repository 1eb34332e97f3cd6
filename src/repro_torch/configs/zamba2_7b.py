"""zamba2-7b [hybrid]: 81L d=3584 32H (MHA) d_ff=14336 vocab=32000,
Mamba2 backbone (ssm_state=64) + shared attention blocks
[arXiv:2411.15242; unverified]."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, act="geglu",
    ssm_state=64, ssm_heads=56, ssm_head_dim=128, attn_every=6,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab=128, ssm_state=8, ssm_heads=4, ssm_head_dim=16,
        attn_every=2, dtype="float32", remat=False)
