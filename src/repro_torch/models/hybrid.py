"""Zamba2-style hybrid (counterpart of ``repro.models.hybrid``): a Mamba2
backbone with one *shared* attention + MLP block applied ahead of every
``attn_every``-th Mamba layer (layers i with ``i % attn_every ==
attn_every - 1``; weights shared across all applications, the Zamba
signature).

A Python loop over layers replaces the reference's scan.  Each
application of the shared block has its own KV cache (its activations
differ), stacked as ``(n_apps, B, S_max, KV, hd)``, so cache memory is
n_apps x, not n_layers x.  Prefill is the cached path with a fill of 0
(multi-token insert), decode the same path with one token.  The family
has no analog hooks and no frontend: ``pack`` and ``prefix_embeds`` are
accepted for the registry's common signature and not used, as in the
reference.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.errors import generator
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import attention_block, init_attention
from repro_torch.models.layers import norm, remat_call
from repro_torch.models.mlp import init_mlp, mlp_block
from repro_torch.models.transformer import (_head, _layer, _norm_init,
                                            _tokens, compute_dtype)
from repro_torch.sharding.perf import batch_rows, local_embedding


def attn_positions(cfg: ModelConfig):
    period = cfg.attn_every
    return [i for i in range(cfg.n_layers) if i % period == period - 1]


def n_attn_apps(cfg: ModelConfig) -> int:
    return len(attn_positions(cfg))


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """float32 master parameters drawn from ``seed`` on ``device``."""
    gen = generator(seed, device)
    d, l, v = cfg.d_model, cfg.n_layers, cfg.vocab
    f32 = dict(dtype=torch.float32, device=device)

    def normal(*shape):
        return torch.randn(shape, generator=gen, **f32)

    embed = normal(v, d) * d ** -0.5
    shared = {
        "attn": _layer(init_attention(gen, cfg, 1, device), 0),
        "mlp": _layer(init_mlp(gen, d, cfg.d_ff, cfg.act, 1, device), 0),
        "norm1": _norm_init(cfg, None, f32),
        "norm2": _norm_init(cfg, None, f32),
    }
    return {
        "embed": embed,
        "final_norm": {"scale": torch.zeros((d,), **f32)},
        "lm_head": normal(d, v) * d ** -0.5,
        "layers": {"mamba": ssm_mod.init_mamba(gen, cfg, l, device),
                   "norm": _norm_init(cfg, l, f32)},
        "shared": shared,
    }


def _shared_attn(cfg, sp, x, *, positions, kv_cache, cache_len):
    h, new_kv = attention_block(
        sp["attn"], norm(x, sp["norm1"], cfg.norm), cfg,
        positions=positions, window=None, cache=kv_cache,
        cache_len=cache_len)
    x = x + h
    x = x + mlp_block(sp["mlp"], norm(x, sp["norm2"], cfg.norm), cfg.act)
    return x, new_kv


def _run(cfg: ModelConfig, params: dict, x: torch.Tensor, *, positions,
         state: Optional[dict], kv: Optional[dict], cache_len,
         remat: bool = False):
    """All layers; returns (x, the stacked Mamba states).  The shared
    block's KV caches (``kv``) are written in place.  ``remat``
    checkpoints each layer, the shared block ahead of it included (the
    reference's scan body)."""
    decode = x.shape[1] == 1 and cache_len is not None
    apps = attn_positions(cfg)

    def layer(i, p_l, shared, x):
        if i in apps:
            app = apps.index(i)
            x, _ = _shared_attn(cfg, shared, x, positions=positions,
                                kv_cache=None if kv is None
                                else _layer(kv, app), cache_len=cache_len)
        h, new_state = ssm_mod.mamba_block(
            p_l["mamba"], norm(x, p_l["norm"], cfg.norm), cfg,
            state=None if state is None else _layer(state, i), decode=decode)
        return x + h, new_state

    states = []
    for i in range(cfg.n_layers):
        x, new_state = remat_call(remat, functools.partial(layer, i),
                                  _layer(params["layers"], i),
                                  params["shared"], x)
        states.append(new_state)
    return x, {n: torch.stack([s[n] for s in states]) for n in states[0]}


def _embed(cfg: ModelConfig, params: dict, tokens) -> torch.Tensor:
    """Token embeddings in ``cfg.dtype``, looked up as the dense family's
    (``transformer._embed``): on a mesh each rank in its shard of the
    table, the rows laid out as the batch."""
    return batch_rows(local_embedding(
        params["embed"], _tokens(params, tokens))).to(compute_dtype(cfg))


def forward(cfg: ModelConfig, params: dict, tokens, *, pack=None,
            prefix_embeds=None, remat: Optional[bool] = None):
    """Training/eval forward: returns (float32 logits, {}).  ``remat``
    (default ``cfg.remat``) checkpoints each layer while a gradient is
    recorded; the values do not change."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run(cfg, params, x, positions=positions, state=None, kv=None,
                cache_len=None, remat=cfg.remat if remat is None else remat)
    return _head(cfg, params, x, None), {}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    dtype = compute_dtype(cfg)
    l, apps = cfg.n_layers, n_attn_apps(cfg)
    st = ssm_mod.mamba_state_init(cfg, batch, dtype, device=device)
    shape = (apps, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "state": {n: a[None].expand((l,) + a.shape).clone()
                  for n, a in st.items()},
        "kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
               "v": torch.zeros(shape, dtype=dtype, device=device)},
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def prefill(cfg: ModelConfig, params: dict, tokens, max_len: int, *,
            pack=None, prefix_embeds=None):
    """Process a prompt: (last-token logits, cache)."""
    x = _embed(cfg, params, tokens)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max_len, device=x.device)
    x, states = _run(cfg, params, x,
                     positions=torch.arange(s, device=x.device),
                     state=cache["state"], kv=cache["kv"],
                     cache_len=torch.zeros((), dtype=torch.int32,
                                           device=x.device))
    logits = _head(cfg, params, x[:, -1:], None)
    return logits, {"state": states, "kv": cache["kv"],
                    "len": torch.tensor(s, dtype=torch.int32,
                                        device=x.device)}


def decode_step(cfg: ModelConfig, params: dict, token, cache: dict, *,
                pack=None):
    """One decode step (the KV caches written in place)."""
    x = _embed(cfg, params, token)
    t = cache["len"]
    positions = t + torch.arange(1, device=x.device)[None, :]
    x, states = _run(cfg, params, x, positions=positions,
                     state=cache["state"], kv=cache["kv"], cache_len=t)
    logits = _head(cfg, params, x, None)
    return logits, {"state": states, "kv": cache["kv"], "len": t + 1}
