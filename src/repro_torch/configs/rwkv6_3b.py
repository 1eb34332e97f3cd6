"""rwkv6-3b "Finch" [ssm]: 32L d=2560 (attention-free) d_ff=8960
vocab=65536, data-dependent decay [arXiv:2404.05892; hf]."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, act="gelu", rwkv=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab=128, dtype="float32", remat=False)
