"""Whisper-style encoder-decoder, the audio family (counterpart of
``repro.models.encdec``).

The conv/mel frontend is a stub: the caller supplies frame embeddings
(B, n_frames, d) as ``frames`` (or the generic ``prefix_embeds``).  The
encoder is a bidirectional pre-LN transformer with sinusoidal positions;
the decoder runs causal self-attention, cross-attention against the
encoder's K/V (projected once per layer) and an MLP.  The decode cache
holds the decoder's self-attention K/V (written in place) and the fixed
cross-attention K/V ``ckv``.  The family has no analog hooks and no
batched decode loop (each utterance needs its own encoder state), as in
the reference.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.errors import generator
from repro_torch.core.quant import div_as_compiled
from repro_torch.models.attention import (attention_block,
                                          cross_attention_block,
                                          encode_cross_kv, init_attention)
from repro_torch.models.layers import norm, remat_call
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.models.transformer import (_layer, _norm_init, _tokens,
                                            compute_dtype)


def _sinusoid_rows(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Rows ``pos`` of the sinusoidal table, float32 (len(pos), d)."""
    dim = torch.arange(d // 2, device=pos.device).to(torch.float32)[None, :]
    ang = pos.to(torch.float32)[:, None] / (
        10000.0 ** div_as_compiled(2 * dim, d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoid(n: int, d: int, device) -> torch.Tensor:
    return _sinusoid_rows(torch.arange(n, device=device), d)


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """float32 master parameters drawn from ``seed`` on ``device``."""
    gen = generator(seed, device)
    d, v = cfg.d_model, cfg.vocab
    le, ld = cfg.n_enc_layers, cfg.n_layers
    f32 = dict(dtype=torch.float32, device=device)
    enc = {
        "attn": init_attention(gen, cfg, le, device),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, le, device),
        "norm1": _norm_init(cfg, le, f32),
        "norm2": _norm_init(cfg, le, f32),
    }
    dec = {
        "attn": init_attention(gen, cfg, ld, device),
        "xattn": init_attention(gen, cfg, ld, device),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, ld, device),
        "norm1": _norm_init(cfg, ld, f32),
        "normx": _norm_init(cfg, ld, f32),
        "norm2": _norm_init(cfg, ld, f32),
    }
    return {
        "embed": torch.randn((v, d), generator=gen, **f32) * d ** -0.5,
        "enc_in": torch.randn((d, d), generator=gen, **f32) * d ** -0.5,
        "encoder": enc,
        "decoder": dec,
        "enc_final_norm": _norm_init(cfg, None, f32),
        "final_norm": _norm_init(cfg, None, f32),
    }


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, n_frames, d) stub embeddings in ``cfg.dtype`` -> the
    encoder's states.  ``remat`` checkpoints each layer."""
    _, s, d = frames.shape
    dt = frames.dtype
    x = frames @ params["enc_in"].to(dt) \
        + _sinusoid(s, d, frames.device)[None].to(dt)
    positions = torch.arange(s, device=x.device)

    def layer(p_l, x):
        h, _ = attention_block(p_l["attn"], norm(x, p_l["norm1"], cfg.norm),
                               cfg, positions=positions, window=None,
                               causal=False)
        x = x + h
        return x + mlp_block(p_l["mlp"], norm(x, p_l["norm2"], cfg.norm),
                             cfg.act)

    for i in range(cfg.n_enc_layers):
        x = remat_call(remat, layer, _layer(params["encoder"], i), x)
    return norm(x, params["enc_final_norm"], cfg.norm)


def _stack_cross_kv(cfg: ModelConfig, params: dict, enc: torch.Tensor):
    """Every decoder layer's cross-attention (K, V), each (L, B, Se, KV,
    hd)."""
    xattn = params["decoder"]["xattn"]
    kvs = [encode_cross_kv({"wk": xattn["wk"][i], "wv": xattn["wv"][i]},
                           enc, cfg) for i in range(cfg.n_layers)]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def _decoder(cfg: ModelConfig, params: dict, x: torch.Tensor, *, positions,
             cross_kv, cache, cache_len, remat: bool = False):
    """All decoder layers: (x, self-attention K/V).  With ``cache`` the
    K/V are written into it in place and it comes back.  ``remat``
    checkpoints each layer."""

    def layer(i, p_l, ck, cv, x):
        h, new_kv = attention_block(
            p_l["attn"], norm(x, p_l["norm1"], cfg.norm), cfg,
            positions=positions, window=None,
            cache=None if cache is None else _layer(cache, i),
            cache_len=cache_len)
        x = x + h
        x = x + cross_attention_block(
            p_l["xattn"], norm(x, p_l["normx"], cfg.norm), (ck, cv), cfg)
        x = x + mlp_block(p_l["mlp"], norm(x, p_l["norm2"], cfg.norm),
                          cfg.act)
        return x, new_kv

    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, new_kv = remat_call(remat, functools.partial(layer, i),
                               _layer(params["decoder"], i),
                               cross_kv[0][i], cross_kv[1][i], x)
        ks.append(new_kv["k"])
        vs.append(new_kv["v"])
    if cache is not None:
        return x, cache
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = norm(x, params["final_norm"], cfg.norm)
    return (x @ params["embed"].T.to(x.dtype)).to(torch.float32)


def _prompt(cfg, params, tokens, frames, remat: bool = False):
    """(decoder input embeddings, cross K/V) of a prompt and its frames."""
    dt = compute_dtype(cfg)
    tokens = _tokens(params, tokens)
    frames = torch.as_tensor(frames, device=tokens.device).to(dt)
    cross_kv = _stack_cross_kv(cfg, params,
                               encode(cfg, params, frames, remat=remat))
    s = tokens.shape[1]
    x = params["embed"][tokens].to(dt) \
        + _sinusoid(s, cfg.d_model, tokens.device)[None].to(dt)
    return x, cross_kv


def forward(cfg: ModelConfig, params: dict, tokens, *, frames=None,
            pack=None, prefix_embeds=None, remat=None):
    """Teacher-forced forward: (float32 logits, {}).  ``frames`` defaults
    to ``prefix_embeds`` (the generic frontend-stub argument).  ``remat``
    (default ``cfg.remat``) checkpoints each encoder and decoder layer
    while a gradient is recorded; the values do not change."""
    frames = frames if frames is not None else prefix_embeds
    remat = cfg.remat if remat is None else remat
    x, cross_kv = _prompt(cfg, params, tokens, frames, remat)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _decoder(cfg, params, x, positions=positions, cross_kv=cross_kv,
                    cache=None, cache_len=None, remat=remat)
    return _logits(cfg, params, x), {}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    kw = dict(dtype=compute_dtype(cfg), device=device)
    l, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((l, batch, max_len, kv, hd), **kw),
        "v": torch.zeros((l, batch, max_len, kv, hd), **kw),
        "ckv": (torch.zeros((l, batch, cfg.cross_kv_len, kv, hd), **kw),
                torch.zeros((l, batch, cfg.cross_kv_len, kv, hd), **kw)),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def prefill(cfg: ModelConfig, params: dict, tokens, max_len: int, *,
            frames=None, pack=None, prefix_embeds=None):
    """Encode the frames and run the prompt: (last-token logits, cache)."""
    frames = frames if frames is not None else prefix_embeds
    x, cross_kv = _prompt(cfg, params, tokens, frames)
    s = x.shape[1]
    x, kv = _decoder(cfg, params, x,
                     positions=torch.arange(s, device=x.device),
                     cross_kv=cross_kv, cache=None, cache_len=None)
    logits = _logits(cfg, params, x[:, -1:])
    kv = {n: F.pad(a, (0, 0, 0, 0, 0, max_len - s)) for n, a in kv.items()}
    return logits, {"k": kv["k"], "v": kv["v"], "ckv": cross_kv,
                    "len": torch.tensor(s, dtype=torch.int32,
                                        device=x.device)}


def decode_step(cfg: ModelConfig, params: dict, token, cache: dict, *,
                pack=None):
    """One decode step (self-attention K/V written in place)."""
    dt = compute_dtype(cfg)
    token = _tokens(params, token)
    t = cache["len"]
    x = params["embed"][token].to(dt) \
        + _sinusoid_rows(t.reshape(1), cfg.d_model)[None].to(dt)
    kv = {"k": cache["k"], "v": cache["v"]}
    x, kv = _decoder(cfg, params, x,
                     positions=t + torch.arange(1, device=x.device)[None, :],
                     cross_kv=cache["ckv"], cache=kv, cache_len=t)
    return _logits(cfg, params, x), {"k": kv["k"], "v": kv["v"],
                                     "ckv": cache["ckv"], "len": t + 1}
