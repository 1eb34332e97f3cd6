"""Decoder-only LM covering the dense / moe / vlm / ssm (rwkv) families
(counterpart of ``repro.models.transformer``).

Parameters are nested dicts of float32 tensors with a leading layer axis
(``params["layers"]["attn"]["wq"]`` is ``(L, d, H * hd)``), laid out as
the reference's so weights carry across (``repro_torch.interop``).  A
Python loop over layers replaces the reference's ``lax.scan``; a pack with
layer bands runs each band's layers under that band's specs.  The analog
path threads an :class:`AnalogPack` whose per-site conductance stacks
are sliced per layer; see ``repro_torch.serve.analog_engine``.

KV caches are ``{"layers": {"attn": {"k", "v"}}, "len"}`` with k/v of
shape ``(L, B, S_max, KV, hd)`` in ``cfg.dtype``; decode steps write into
them in place (see ``models.attention``).  Paged serving keeps a global page
pool ``{"attn": {"k", "v"}}`` of ``(L, P, page_size, KV, hd)`` instead
(:func:`init_page_pool`, :func:`prefill_cached`, :func:`decode_step_paged`).
The rwkv family carries its recurrent state in place of K/V,
``{"layers": {"rwkv": {"wkv", "shift_t", "shift_c"}}, "len"}`` stacked
over layers, and has no ragged, paged or cached-prefix prefill (each
raises with the reference's reason).  MoE layers run ``models.mlp.
moe_block`` (plus the dense MLP beside it where ``cfg.dense_residual``).
``prefix_embeds`` (B, P, d) is the vlm/audio frontend stub: it overwrites
the first P token embeddings.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.analog import AnalogSpec, AnalogWeights, analog_matmul
from repro_torch.core.errors import generator
from repro_torch.hw.profile import Profile, SiteSpecs
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import attention_block, init_attention
from repro_torch.models.layers import AnalogCtx, dense, norm, remat_call
from repro_torch.models.mlp import init_mlp, init_moe, mlp_block, moe_block
from repro_torch.sharding.perf import (FLAGS, batch_rows, constrain_bs,
                                      local_embedding, pad_dim)

GLOBAL_WINDOW = 1 << 30


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activations' dtype named by ``cfg.dtype``."""
    return getattr(torch, cfg.dtype)


@dataclasses.dataclass(frozen=True)
class AnalogPack:
    """Layer-stacked analog weights + calibrated ranges for the LM.

    ``profile`` resolves sites to specs; ``bands`` are its maximal layer
    bands and ``band_specs[i]`` the (site, spec) map serving band ``i``.
    Each site keeps one layer-stacked conductance stack whatever the
    banding (per-band specs agree on array geometry).
    """

    profile: Profile
    bands: Tuple[Tuple[int, int], ...]
    band_specs: Tuple[SiteSpecs, ...]
    layer_weights: Dict[str, AnalogWeights]     # tensors stacked over L
    layer_lo: Dict[str, torch.Tensor]           # (L, S)
    layer_hi: Dict[str, torch.Tensor]
    layer_act: Dict[str, torch.Tensor]          # (L,)
    head: Optional[AnalogWeights] = None        # lm_head
    head_lo: Optional[torch.Tensor] = None
    head_hi: Optional[torch.Tensor] = None
    head_act: Optional[torch.Tensor] = None
    head_spec: Optional[AnalogSpec] = None
    collect: bool = False

    def site_spec(self, name: str) -> AnalogSpec:
        """The spec serving ``name`` (first band where it is analog)."""
        if name == "head" and self.head_spec is not None:
            return self.head_spec
        for ss in self.band_specs:
            s = ss.get(name)
            if s is not None:
                return s
        raise KeyError(f"site {name!r} is not analog in any band of this pack")

    def age(self, t, seed: int) -> "AnalogPack":
        """Device state of this pack at age ``t`` (units of the
        programming-reference time; ``t = 1`` is fresh) under each site's
        drift and fault models; see
        ``repro_torch.serve.analog_engine.age_pack``."""
        from repro_torch.serve.analog_engine import age_pack

        return age_pack(self, t, seed)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> dict:
    """float32 master parameters drawn from ``seed`` on ``device``."""
    gen = generator(seed, device)
    d, l, v = cfg.d_model, cfg.n_layers, cfg.vocab
    f32 = dict(dtype=torch.float32, device=device)
    p: Dict[str, object] = {
        "embed": torch.randn((v, d), generator=gen, **f32) * d ** -0.5,
        "final_norm": _norm_init(cfg, None, f32),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = torch.randn((d, v), generator=gen, **f32) * d ** -0.5
    if cfg.rwkv:
        p["layers"] = {"rwkv": ssm_mod.init_rwkv(gen, cfg, l, device),
                       "norm1": _norm_init(cfg, l, f32),
                       "norm2": _norm_init(cfg, l, f32)}
        return p
    layers: Dict[str, object] = {
        "attn": init_attention(gen, cfg, l, device),
        "norm1": _norm_init(cfg, l, f32),
        "norm2": _norm_init(cfg, l, f32),
    }
    if cfg.n_experts:
        layers["moe"] = init_moe(gen, cfg, l, device)
    if not cfg.n_experts or cfg.dense_residual:
        layers["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.act, l, device)
    p["layers"] = layers
    return p


def _norm_init(cfg: ModelConfig, l: Optional[int], f32: dict) -> dict:
    shape = (cfg.d_model,) if l is None else (l, cfg.d_model)
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, **f32),
                "bias": torch.zeros(shape, **f32)}
    return {"scale": torch.zeros(shape, **f32)}


def layer_windows(cfg: ModelConfig) -> Optional[List[int]]:
    """Per-layer attention window (N local : 1 global pattern)."""
    if cfg.sliding_window is None:
        return None
    if cfg.local_global_ratio == 0:
        return [cfg.sliding_window] * cfg.n_layers
    period = cfg.local_global_ratio + 1
    return [GLOBAL_WINDOW if (i % period) == period - 1 else cfg.sliding_window
            for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# the layer loop
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer ``i`` of a nested dict of layer-stacked tensors (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _block(cfg: ModelConfig, p_l: dict, x: torch.Tensor, *, positions,
           window, cache_l: Optional[dict], cache_len,
           actx: Optional[AnalogCtx], attn_backend: str = "stream",
           paged: Optional[dict] = None):
    """One layer: returns (x, the layer's new cache entry, aux).  The cache
    entry is {"k", "v"} for attention, {"wkv", "shift_t", "shift_c"} for
    rwkv."""
    aux: Dict[str, torch.Tensor] = {}
    if cfg.rwkv:
        decode = cache_len is not None and cache_l is not None
        h, new_t = ssm_mod.rwkv_time_mix(
            p_l["rwkv"], norm(x, p_l["norm1"], cfg.norm), cfg,
            state=cache_l, decode=decode, ctx=actx, aux=aux)
        x = x + h
        h, new_c = ssm_mod.rwkv_channel_mix(
            p_l["rwkv"], norm(x, p_l["norm2"], cfg.norm),
            state=cache_l, decode=decode, ctx=actx, aux=aux)
        return x + h, {**new_t, **new_c}, aux

    h, new_kv = attention_block(
        p_l["attn"], norm(x, p_l["norm1"], cfg.norm), cfg,
        positions=positions, window=window, cache=cache_l,
        cache_len=cache_len, ctx=actx, aux=aux, attn_backend=attn_backend,
        paged=paged)
    x = x + h
    h2_in = norm(x, p_l["norm2"], cfg.norm)
    if cfg.n_experts:
        h, _ = moe_block(p_l["moe"], h2_in, cfg, ctx=actx, aux=aux)
        if cfg.dense_residual:
            h = h + mlp_block(p_l["mlp"], h2_in, cfg.act, actx, aux)
    else:
        h = mlp_block(p_l["mlp"], h2_in, cfg.act, actx, aux)
    return x + h, new_kv, aux


def _make_actx(pack: AnalogPack, layer: int, band: int) -> AnalogCtx:
    """Band-resolved context of one layer: only sites analog in this band
    go through the analog pipeline (the rest run digitally)."""
    ss = pack.band_specs[band]
    names = [n for n in ss.names if n in pack.layer_weights]
    return AnalogCtx(
        specs=ss,
        weights={n: pack.layer_weights[n].layer(layer) for n in names},
        lo={n: pack.layer_lo[n][layer] for n in names if n in pack.layer_lo},
        hi={n: pack.layer_hi[n][layer] for n in names if n in pack.layer_hi},
        act={n: pack.layer_act[n][layer] for n in names
             if n in pack.layer_act},
        collect=pack.collect,
    )


def _stack_aux(auxes: List[dict]) -> Dict[str, torch.Tensor]:
    """Stack per-layer aux entries to (L, ...); layers of bands that do not
    emit a key (digital bands) get zeros, as the reference stitches."""
    keys: List[str] = []
    for a in auxes:
        keys.extend(k for k in a if k not in keys)
    out = {}
    for k in keys:
        proto = next(a[k] for a in auxes if k in a)
        out[k] = torch.stack([a[k] if k in a else torch.zeros_like(proto)
                              for a in auxes])
    return out


def _run_layers(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                positions, cache: Optional[dict], cache_len,
                pack: Optional[AnalogPack], attn_backend: str = "stream",
                paged: Optional[dict] = None, remat: bool = False):
    """All layers, band by band; returns (x, cache, aux).  With ``paged``
    ({"ptab", "backend"}), ``cache`` is the page pool.  Attention caches
    are written in place; rwkv states come back as new stacks.  ``remat``
    checkpoints each layer (``layers.remat_call``)."""
    windows = layer_windows(cfg)
    bands = pack.bands if pack is not None else ((0, cfg.n_layers),)
    group = "rwkv" if cfg.rwkv else "attn"
    news, auxes = [], []
    for band, (lo_b, hi_b) in enumerate(bands):
        for i in range(lo_b, hi_b):
            block = functools.partial(
                _block, cfg, positions=positions,
                window=None if windows is None else windows[i],
                cache_l=None if cache is None else _layer(cache[group], i),
                cache_len=cache_len,
                actx=None if pack is None else _make_actx(pack, i, band),
                attn_backend=attn_backend, paged=paged)
            x, new_l, aux = remat_call(remat, block,
                                       _layer(params["layers"], i), x)
            news.append(new_l)
            auxes.append(aux)
    if cache is None or cfg.rwkv:
        cache = {group: {n: torch.stack([c[n] for c in news])
                         for n in news[0]}}
    return x, cache, _stack_aux(auxes)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _tokens(params: dict, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def forward(cfg: ModelConfig, params: dict, tokens, *,
            prefix_embeds=None, pack: Optional[AnalogPack] = None,
            remat: Optional[bool] = None) -> Tuple[torch.Tensor, dict]:
    """Training/eval forward: returns (float32 logits, aux).  ``remat``
    (default ``cfg.remat``) checkpoints each layer while a gradient is
    recorded; the values do not change."""
    tokens = _tokens(params, tokens)
    x = _maybe_seq_shard(_embed(cfg, params, tokens, prefix_embeds))
    positions = torch.arange(tokens.shape[1], device=x.device)
    x, _, aux = _run_layers(cfg, params, x, positions=positions, cache=None,
                            cache_len=None, pack=pack,
                            remat=cfg.remat if remat is None else remat)
    if pack is not None and pack.collect:
        aux["final_hidden"] = norm(x, params["final_norm"], cfg.norm)
    return _head(cfg, params, x, pack), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    length = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.rwkv:
        st = ssm_mod.rwkv_state_init(cfg, batch, compute_dtype(cfg),
                                     device=device)
        return {"layers": {"rwkv": {
            n: a[None].expand((cfg.n_layers,) + a.shape).clone()
            for n, a in st.items()}}, "len": length}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    kw = dict(dtype=compute_dtype(cfg), device=device)
    return {"layers": {"attn": {"k": torch.zeros(shape, **kw),
                                "v": torch.zeros(shape, **kw)}},
            "len": length}


def prefill(cfg: ModelConfig, params: dict, tokens, max_len: int, *,
            prefix_embeds=None,
            pack: Optional[AnalogPack] = None) -> Tuple[torch.Tensor, dict]:
    """Process a prompt, returning (last-token logits, cache).  An rwkv
    cache is the state after the prompt (no padding to ``max_len``)."""
    tokens = _tokens(params, tokens)
    s = tokens.shape[1]
    x = _maybe_seq_shard(_embed(cfg, params, tokens, prefix_embeds))
    positions = torch.arange(s, device=x.device)
    x, new_cache, _ = _run_layers(cfg, params, x, positions=positions,
                                  cache=None, cache_len=None, pack=pack)
    logits = _head(cfg, params, x[:, -1:], pack)
    length = torch.tensor(s, dtype=torch.int32, device=x.device)
    if cfg.rwkv:
        return logits, {"layers": new_cache, "len": length}
    kv = {n: pad_dim(a, -3, max_len - s)
          for n, a in new_cache["attn"].items()}
    return logits, {"layers": {"attn": kv}, "len": length}


def decode_step(cfg: ModelConfig, params: dict, token, cache: dict, *,
                pack: Optional[AnalogPack] = None,
                attn_backend: str = "stream") -> Tuple[torch.Tensor, dict]:
    """One decode step with a KV cache (written in place).

    ``cache["len"]`` is a 0-d fill (every row at the same fill, the
    ``greedy_decode`` path) or a per-row ``(B,)`` vector (continuous
    batching).  ``attn_backend="stream"`` runs the online-softmax
    attention, ``"flash"`` the flash-decode CUDA kernel
    (``kernels.ops.flash_attention_decode``; no sliding-window support),
    ``"flash_oracle"`` its plain PyTorch version.
    """
    if attn_backend not in ("stream", "flash", "flash_oracle"):
        raise ValueError(f"unknown attn_backend {attn_backend!r}")
    if attn_backend != "stream" and cfg.rwkv:
        raise ValueError("attn_backend applies to attention caches only; "
                         "rwkv has no KV cache")
    if attn_backend != "stream" and cfg.sliding_window is not None:
        raise ValueError("the flash-decode kernel has no sliding-window "
                         "mask; use attn_backend='stream'")
    token = _tokens(params, token)
    x = _embed(cfg, params, token)
    t = cache["len"]
    one = torch.arange(1, device=x.device)
    positions = t[:, None] + one[None, :] if t.ndim else t + one[None, :]
    x, layers, _ = _run_layers(cfg, params, x, positions=positions,
                               cache=cache["layers"], cache_len=t, pack=pack,
                               attn_backend=attn_backend)
    logits = _head(cfg, params, x, pack)
    return logits, {"layers": layers, "len": t + 1}


def prefill_ragged(cfg: ModelConfig, params: dict, tokens, *, true_lens,
                   pack: Optional[AnalogPack] = None
                   ) -> Tuple[torch.Tensor, dict]:
    """Variable-length prefill for continuous batching: ``tokens`` is a
    right-padded batch, ``true_lens`` each row's real length.  Returns
    per-row logits at ``true_lens - 1`` (B, 1, V) and a cache whose
    ``len`` is ``true_lens``.  Pad positions hold K/V at indices >= the
    row's fill, which decode's ``kv_len`` mask never reads."""
    if cfg.rwkv:
        raise ValueError(
            "prefill_ragged does not support the rwkv family: the "
            "recurrent state folds right-pad tokens into every row; "
            "serve rwkv prompts at exact length via prefill() instead")
    tokens = _tokens(params, tokens)
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, device=x.device)
    x, new_cache, _ = _run_layers(cfg, params, x, positions=positions,
                                  cache=None, cache_len=None, pack=pack)
    true_lens = torch.as_tensor(true_lens, device=x.device).to(torch.int32)
    idx = (true_lens.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
    last = torch.gather(x, 1, idx)
    return _head(cfg, params, last, pack), {"layers": new_cache,
                                            "len": true_lens}


def init_page_pool(cfg: ModelConfig, num_pages: int, page_size: int, *,
                   device="cuda") -> dict:
    """Global paged KV pool: ``num_pages`` pages of ``page_size`` positions
    per layer, ``{"attn": {"k", "v"}}`` of ``(L, P, page_size, KV, hd)`` in
    ``cfg.dtype``.  Page 0 is the sink page (``serve.kvpool`` never hands it
    out): rows without a live allocation scatter their decode K/V there, and
    no live row's block table references it."""
    if cfg.rwkv:
        raise ValueError("paged KV applies to attention caches only; "
                         "rwkv state is O(1) per slot already")
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    kw = dict(dtype=compute_dtype(cfg), device=device)
    return {"attn": {"k": torch.zeros(shape, **kw),
                     "v": torch.zeros(shape, **kw)}}


def prefill_cached(cfg: ModelConfig, params: dict, tokens, *, true_lens,
                   ctx_lens, ctx_cache: dict,
                   pack: Optional[AnalogPack] = None
                   ) -> Tuple[torch.Tensor, dict]:
    """Ragged prefill of prompt suffixes over per-row cached prefixes.

    ``tokens`` (B, S) are right-padded suffixes, ``true_lens`` (B,) their
    lengths; each row already owns ``ctx_lens[b]`` valid positions of
    ``ctx_cache`` {"k", "v"} ``(L, B, C, KV, hd)``.  The caller passes a
    copy of the shared pages (gathered from the pool), never the pool
    itself: this function pads it to ``C + S`` and writes the suffix's K/V
    into the padded copy, which a shared page must never see.  Every
    matmul still goes through ``pack`` as a cold prefill would.

    Returns per-row logits at suffix position ``true_lens - 1`` (B, 1, V)
    and a cache holding the context in ``[0, C)`` and the suffix at
    ``ctx_lens + [0, S)``, with ``len`` the total fill ``ctx_lens +
    true_lens``."""
    if cfg.rwkv:
        raise ValueError("prefill_cached does not support the rwkv family")
    tokens = _tokens(params, tokens)
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    ctx_lens = torch.as_tensor(ctx_lens, device=x.device).to(torch.int32)
    positions = ctx_lens[:, None] + torch.arange(s, device=x.device)[None, :]
    padded = {n: F.pad(a, (0, 0, 0, 0, 0, s)) for n, a in ctx_cache.items()}
    x, new_cache, _ = _run_layers(cfg, params, x, positions=positions,
                                  cache={"attn": padded}, cache_len=ctx_lens,
                                  pack=pack)
    true_lens = torch.as_tensor(true_lens, device=x.device).to(torch.int32)
    idx = (true_lens.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
    last = torch.gather(x, 1, idx)
    return _head(cfg, params, last, pack), {"layers": new_cache,
                                            "len": ctx_lens + true_lens}


PAGED_BACKENDS = ("gather", "kernel", "oracle")


def decode_step_paged(cfg: ModelConfig, params: dict, token, cache: dict, *,
                      pack: Optional[AnalogPack] = None,
                      backend: str = "gather") -> Tuple[torch.Tensor, dict]:
    """One decode step over the paged KV pool (written in place).

    ``cache`` is ``{"pool": init_page_pool(...), "ptab": (B, NP) block
    table on the pool's device, "len": (B,) fills}``.  ``backend="gather"``
    runs the dense decode's streaming attention over the gathered view
    ``pool[ptab]`` (the configuration that equals the dense runtime token
    for token), ``"kernel"`` the paged-attention CUDA kernel
    (``kernels.ops.paged_attention``; no sliding-window mask), ``"oracle"``
    its plain PyTorch version.
    """
    if backend not in PAGED_BACKENDS:
        raise ValueError(f"unknown paged backend {backend!r}; choose from "
                         f"{PAGED_BACKENDS}")
    if backend != "gather" and cfg.sliding_window is not None:
        raise ValueError("the paged-attention kernel has no sliding-window "
                         "mask; use backend='gather'")
    token = _tokens(params, token)
    x = _embed(cfg, params, token)
    t = torch.as_tensor(cache["len"], device=x.device).to(torch.int32)
    positions = t[:, None] + torch.arange(1, device=x.device)[None, :]
    x, pool, _ = _run_layers(cfg, params, x, positions=positions,
                             cache=cache["pool"], cache_len=t, pack=pack,
                             paged={"ptab": cache["ptab"], "backend": backend})
    logits = _head(cfg, params, x, pack)
    return logits, {"pool": pool, "ptab": cache["ptab"], "len": t + 1}


def cache_slot_insert(slot_cache: dict, new_cache: dict,
                      slots) -> dict:
    """Insert freshly prefilled rows into a running slot cache, in place.

    Slot leaves are ``(L, max_slots, S_max, ...)``, new leaves
    ``(L, G, s, ...)`` with ``s <= S_max`` (the rest of the row is zeroed,
    as the reference zero-pads).  ``slots`` (G,) names each row's slot;
    out-of-range ids are dropped (the runtime's padding rows).
    """
    slot_k = slot_cache["layers"]["attn"]["k"]
    dev = slot_k.device
    slots = torch.as_tensor(slots, device=dev).long()
    keep = slots < slot_k.shape[1]
    rows, dst = keep.nonzero()[:, 0], slots[keep]
    for name, dst_t in slot_cache["layers"]["attn"].items():
        src = new_cache["layers"]["attn"][name][:, rows].to(dst_t.dtype)
        s = src.shape[2]
        dst_t[:, dst, :s] = src
        dst_t[:, dst, s:] = 0
    length = slot_cache["len"]
    length[dst] = torch.as_tensor(new_cache["len"], device=dev) \
        .to(length.dtype)[rows]
    return slot_cache


def cache_slot_evict(slot_cache: dict, slots) -> dict:
    """Zero freed slot rows in place (hygiene only: the per-slot
    ``kv_len`` mask already makes evicted data unreachable)."""
    dev = slot_cache["len"].device
    slots = torch.as_tensor(slots, device=dev).long()
    slots = slots[slots < slot_cache["len"].shape[0]]
    for dst_t in slot_cache["layers"]["attn"].values():
        dst_t[:, slots] = 0
    slot_cache["len"][slots] = 0
    return slot_cache


def greedy_decode(cfg: ModelConfig, params: dict, prompts, n_new: int, *,
                  prefix_embeds=None,
                  pack: Optional[AnalogPack] = None) -> torch.Tensor:
    """Batched greedy generation: one prefill, then ``n_new - 1`` decode
    steps; returns the (B, n_new) generated tokens."""
    if n_new < 1:
        raise ValueError(f"greedy_decode needs n_new >= 1, got {n_new}")
    prompts = _tokens(params, prompts)
    s = prompts.shape[1]
    logits, cache = prefill(cfg, params, prompts, s + n_new - 1,
                            prefix_embeds=prefix_embeds, pack=pack)
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok]
    for _ in range(n_new - 1):
        lg, cache = decode_step(cfg, params, tok[:, None], cache, pack=pack)
        tok = torch.argmax(lg[:, -1], dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


# ---------------------------------------------------------------------------


def _maybe_seq_shard(x):
    """Whole-stream sequence parallelism (``FLAGS.seq_parallel_attn``):
    a prompt's activations sequence-sharded over ``model``."""
    if FLAGS.seq_parallel_attn and x.shape[1] > 1:
        return constrain_bs(x, seq=True)
    return x


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           prefix_embeds=None):
    """Token embeddings in ``cfg.dtype``; ``prefix_embeds`` (B, P, d), the
    frontend stub's, replace the first P positions.  On a mesh each rank
    looks up the tokens in its shard of the table
    (``sharding.perf.local_embedding``), and the rows come out laid out as
    the batch."""
    dt = compute_dtype(cfg)
    x = batch_rows(local_embedding(params["embed"], tokens)).to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if prefix_embeds is not None:
        pre = torch.as_tensor(prefix_embeds, device=x.device).to(dt)
        if pre.shape[1] > x.shape[1]:
            raise ValueError(f"{pre.shape[1]} prefix embeddings do not fit "
                             f"in {x.shape[1]} token positions")
        x = torch.cat([pre, x[:, pre.shape[1]:]], dim=1)
    return x


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor,
          pack: Optional[AnalogPack]) -> torch.Tensor:
    x = norm(x, params["final_norm"], cfg.norm)
    if pack is not None and pack.head is not None and not pack.collect:
        y = analog_matmul(x, pack.head, pack.head_spec, adc_lo=pack.head_lo,
                          adc_hi=pack.head_hi, act_hi=pack.head_act)
        return y.to(torch.float32)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return dense(x, w, "lm_head", None).to(torch.float32)
