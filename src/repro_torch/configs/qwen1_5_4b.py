"""qwen1.5-4b [dense]: 40L d=2560 20H (MHA kv=20) d_ff=6912 vocab=151936,
QKV bias [hf:Qwen/Qwen1.5 family; hf]."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab=151936, act="swiglu", qkv_bias=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab=128, dtype="float32", remat=False)
