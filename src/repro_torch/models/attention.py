"""Attention block: GQA/MQA, RoPE, optional QKV bias / per-head qk-norm /
sliding window, prefill, dense-cache decode and paged decode, and the
encoder-decoder's cross attention (counterpart of
``repro.models.attention``).

Decode writes the new token's K/V into the cache (or the page pool) **in
place** (the reference builds a new array with ``.at[].set``): the callers
never read the old cache again, and the slot cache or pool of a server is
the largest activation-side buffer there is.  On a mesh each rank writes
its own shard of the cache (``sharding.perf.write_local``).

``FLAGS.seq_parallel_attn`` (the reference's context parallelism) keeps
a prompt's queries sequence-sharded over ``model`` around the attention
and gathers K/V (``sharding.perf.constrain_bs``): a layout, no value
changes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import ModelConfig
from repro_torch.models.layers import (AnalogCtx, dense, rms_norm, rope,
                                       streaming_attention)
from repro_torch.sharding.perf import (FLAGS, constrain_bs, split_heads,
                                      write_local)


def init_attention(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
                   device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    sc = d ** -0.5
    p = {
        "wq": normal(n_layers, d, h * hd) * sc,
        "wk": normal(n_layers, d, kv * hd) * sc,
        "wv": normal(n_layers, d, kv * hd) * sc,
        "wo": normal(n_layers, h * hd, d) * (h * hd) ** -0.5,
    }
    zeros = dict(dtype=torch.float32, device=device)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n_layers, h * hd), **zeros)
        p["bk"] = torch.zeros((n_layers, kv * hd), **zeros)
        p["bv"] = torch.zeros((n_layers, kv * hd), **zeros)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((n_layers, hd), **zeros)
        p["k_norm"] = torch.zeros((n_layers, hd), **zeros)
    return p


def _write_cache(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """Write ``new`` (B, s, KV, hd) at per-row positions ``pos`` (B, s) of
    ``cache`` (B, S_max, KV, hd), in place.  Positions past the end are
    dropped, like the reference's scatter.  A cache on a mesh is written
    shard by shard (:func:`sharding.perf.write_local`)."""
    if isinstance(cache, DTensor) or isinstance(new, DTensor):
        write_local(_write_cache, cache, new, pos, seq_dim=1)
        return
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    inside = (pos >= 0) & (pos < cache.shape[1])
    pos_c = torch.clamp(pos, max=cache.shape[1] - 1)
    keep = cache[rows, pos_c]
    cache[rows, pos_c] = torch.where(inside[..., None, None],
                                     new.to(cache.dtype), keep)


def attention_block(
    p: dict,                       # per-layer slice (no leading L axis)
    x: torch.Tensor,               # (B, S, d)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,       # (S,) or (B, S) absolute positions
    window,                        # None or a per-layer window
    cache: Optional[dict] = None,  # {"k","v"}: (B, S_max, KV, hd)
    cache_len=None,                # current fill: 0-d or (B,) tensor
    causal: bool = True,
    ctx: Optional[AnalogCtx] = None,
    aux: Optional[dict] = None,
    attn_backend: str = "stream",  # dense decode: stream | flash | flash_oracle
    paged: Optional[dict] = None,  # {"ptab", "backend"}: paged decode
) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    seq_par = FLAGS.seq_parallel_attn and cache is None and s > 1

    q = dense(x, p["wq"], "wq", ctx, aux, bias=p.get("bq"))
    k = dense(x, p["wk"], "wk", ctx, aux, bias=p.get("bk"))
    v = dense(x, p["wv"], "wv", ctx, aux, bias=p.get("bv"))
    q = split_heads(q, h)
    k = split_heads(k, kv)
    v = split_heads(v, kv)

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"].to(q.dtype))
        k = rms_norm(k, p["k_norm"].to(k.dtype))

    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if paged is not None:
        out = _paged_decode(q, k, v, cache, cache_len, paged, causal=causal,
                            window=window)
        out = out.reshape(b, s, h * hd)
        return dense(out, p["wo"], "wo", ctx, aux), cache

    if cache is None:
        if seq_par:
            # context parallelism: queries stay sequence-sharded; K/V are
            # gathered over the model axis (cheap: kv_heads*hd << d)
            q = constrain_bs(q, seq=True)
            k = constrain_bs(k, seq=False)
            v = constrain_bs(v, seq=False)
        out = streaming_attention(q, k, v, q_offset=0, causal=causal,
                                  window=window)
        if seq_par:
            out = constrain_bs(out, seq=True)
        new_cache = {"k": k, "v": v}
    else:
        # decode: insert the new token(s) at each row's fill, attend over
        # the cache
        fill = torch.as_tensor(cache_len, device=x.device)
        pos = (fill.reshape(-1, 1).expand(b, 1)
               + torch.arange(s, device=x.device)[None, :])
        ck, cv = cache["k"], cache["v"]
        _write_cache(ck, k, pos)
        _write_cache(cv, v, pos)
        if attn_backend != "stream":
            # flash-decode kernel over the dense per-slot cache; no
            # sliding-window mask (decode_step rejects windowed configs)
            if s != 1:
                raise ValueError("flash attention is a decode path "
                                 "(S == 1); prefill uses streaming")
            from repro_torch.kernels.ops import flash_attention_decode

            fills = (fill + s).to(torch.int32).reshape(-1).expand(b)
            be = "oracle" if attn_backend == "flash_oracle" else "kernel"
            out = flash_attention_decode(q[:, 0], ck, cv, fills,
                                         backend=be)[:, None]
        else:
            out = streaming_attention(q, ck, cv, q_offset=fill, causal=causal,
                                      window=window, kv_len=fill + s)
        new_cache = {"k": ck, "v": cv}

    out = out.reshape(b, s, h * hd)
    return dense(out, p["wo"], "wo", ctx, aux), new_cache


def _paged_decode(q, k, v, pool: dict, cache_len, paged: dict, *, causal,
                  window) -> torch.Tensor:
    """Paged decode: ``pool`` {"k", "v"} is a global ``(P, ps, KV, hd)``
    page pool and ``paged["ptab"]`` (B, NP) each row's page list.  The fresh
    token's K/V are scattered in place at ``(ptab[b, clip(pos // ps, 0,
    NP - 1)], pos % ps)``; a row whose table entry is unallocated (0) writes
    into the sink page, which no live row's ``kv_len`` mask reaches.  Then
    backend ``"gather"`` runs the dense decode's ``streaming_attention``
    over ``pool[ptab]`` viewed as ``(B, NP * ps, KV, hd)`` (with
    ``NP * ps == max_len`` the same computation as the dense slot cache),
    ``"kernel"`` the paged-attention kernel and ``"oracle"`` its plain
    version (``ops.paged_attention``)."""
    b, s, _, _ = q.shape
    if s != 1:
        raise ValueError("paged attention is a decode path (S == 1); "
                         "prefill goes through the dense cached path")
    pk, pv = pool["k"], pool["v"]
    ps = pk.shape[1]
    ptab = paged["ptab"]
    n_pages = ptab.shape[1]
    pos = torch.as_tensor(cache_len, device=q.device).long().reshape(-1) \
        .expand(b)
    idx = torch.clamp(pos // ps, 0, n_pages - 1)
    pid = torch.gather(ptab.long(), 1, idx[:, None])[:, 0]
    off = pos % ps
    pk[pid, off] = k[:, 0].to(pk.dtype)
    pv[pid, off] = v[:, 0].to(pv.dtype)
    if paged["backend"] == "gather":
        kv_heads, hd = pk.shape[2], pk.shape[3]
        gk = pk[ptab.long()].reshape(b, n_pages * ps, kv_heads, hd)
        gv = pv[ptab.long()].reshape(b, n_pages * ps, kv_heads, hd)
        return streaming_attention(q, gk, gv, q_offset=pos, causal=causal,
                                   window=window, kv_len=pos + 1)
    from repro_torch.kernels.ops import paged_attention

    return paged_attention(q[:, 0], pk, pv, ptab, pos + 1,
                           backend=paged["backend"])[:, None]


def cross_attention_block(p: dict, x: torch.Tensor,
                          enc_kv: Tuple[torch.Tensor, torch.Tensor],
                          cfg: ModelConfig, *,
                          ctx: Optional[AnalogCtx] = None,
                          aux: Optional[dict] = None) -> torch.Tensor:
    """Whisper-style cross attention of the decoder stream x (B, S, d)
    against cached encoder K/V, each (B, Senc, KV, hd)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q = split_heads(dense(x, p["wq"], "xattn_wq", ctx, aux), h)
    k, v = enc_kv
    out = streaming_attention(q, k, v, q_offset=0, causal=False, window=None)
    return dense(out.reshape(b, s, h * hd), p["wo"], "xattn_wo", ctx, aux)


def encode_cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the encoder's output once into cross-attention K/V."""
    b, se, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    k = split_heads(dense(enc_out, p["wk"], "xattn_wk", None), kv)
    v = split_heads(dense(enc_out, p["wv"], "xattn_wv", None), kv)
    return k, v
