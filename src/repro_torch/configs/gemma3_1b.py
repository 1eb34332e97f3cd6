"""gemma3-1b [dense]: 26L d=1152 4H (kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding-window attention, 128k ctx
[hf:google/gemma-3-1b-pt; unverified]."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144, act="geglu", qk_norm=True,
    tie_embeddings=True, embed_scale=True,
    sliding_window=1024, local_global_ratio=5, rope_theta=1_000_000.0,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=96, vocab=128, sliding_window=8, local_global_ratio=2,
        dtype="float32", remat=False)
