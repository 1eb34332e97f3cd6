"""internvl2-26b [vlm]: 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
(InternLM2-20B text backbone); InternViT frontend is a STUB — input_specs
supplies precomputed patch embeddings [arXiv:2404.16821; hf]."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, act="swiglu",
    frontend="vision_patches", n_frontend_tokens=256,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=128, n_frontend_tokens=4, dtype="float32", remat=False)
