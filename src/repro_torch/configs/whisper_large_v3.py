"""whisper-large-v3 [audio]: 32+32L enc-dec, d=1280 20H (MHA) d_ff=5120
vocab=51866; conv/mel frontend is a STUB (precomputed frame embeddings)
[arXiv:2212.04356; unverified].  Assigned seq shapes apply to the decoder
token stream; the encoder runs the fixed 1500-frame (30 s) window."""

import dataclasses

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, act="gelu", norm="layernorm",
    tie_embeddings=True, frontend="audio_frames", n_frontend_tokens=1500,
    cross_kv_len=1500,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab=128, n_frontend_tokens=8,
        cross_kv_len=8, dtype="float32", remat=False)
