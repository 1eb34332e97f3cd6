"""Model registry (counterpart of ``repro.models.registry``): family ->
entry points.  dense / moe / vlm / ssm (rwkv) run on the unified
transformer; the hybrid and the encoder-decoder have their own modules
and no batched decode loop, continuous batching or paged KV."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.config import ModelConfig
from repro_torch.models import encdec, hybrid, transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable
    forward: Callable          # (cfg, params, tokens, **kw) -> (logits, aux)
    prefill: Callable          # (cfg, params, tokens, max_len, **kw)
    decode_step: Callable      # (cfg, params, token, cache, **kw)
    init_cache: Callable       # (cfg, batch, max_len, *, device)
    # batched greedy serving loop: (cfg, params, prompts, n_new, **kw)
    # -> (B, n_new) tokens; None for families without one
    decode_loop: Optional[Callable] = None
    # continuous batching (serve.runtime): right-padded prefill and
    # slot-wise cache insert/evict
    prefill_ragged: Optional[Callable] = None
    cache_slot_insert: Optional[Callable] = None
    cache_slot_evict: Optional[Callable] = None
    # paged-KV serving (serve.paged): global page pool, ragged suffix
    # prefill over shared prefixes, block-table decode
    init_page_pool: Optional[Callable] = None
    prefill_cached: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None


_TRANSFORMER = ModelApi(
    init_params=transformer.init_params,
    forward=transformer.forward,
    prefill=transformer.prefill,
    decode_step=transformer.decode_step,
    init_cache=transformer.init_cache,
    decode_loop=transformer.greedy_decode,
    prefill_ragged=transformer.prefill_ragged,
    cache_slot_insert=transformer.cache_slot_insert,
    cache_slot_evict=transformer.cache_slot_evict,
    init_page_pool=transformer.init_page_pool,
    prefill_cached=transformer.prefill_cached,
    decode_step_paged=transformer.decode_step_paged,
)

_HYBRID = ModelApi(
    init_params=hybrid.init_params,
    forward=hybrid.forward,
    prefill=hybrid.prefill,
    decode_step=hybrid.decode_step,
    init_cache=hybrid.init_cache,
)

_ENCDEC = ModelApi(
    init_params=encdec.init_params,
    forward=encdec.forward,
    prefill=encdec.prefill,
    decode_step=encdec.decode_step,
    init_cache=encdec.init_cache,
)

_BY_FAMILY = {
    "audio": _ENCDEC,
    "hybrid": _HYBRID,
    "dense": _TRANSFORMER,
    "moe": _TRANSFORMER,
    "vlm": _TRANSFORMER,
    "ssm": _TRANSFORMER,
}


def families_with(attr: str) -> tuple:
    """Families whose ModelApi provides ``attr`` (derived from the
    registry, so error messages cannot drift from it)."""
    return tuple(sorted(f for f, api in _BY_FAMILY.items()
                        if getattr(api, attr) is not None))


def decode_loop_families() -> tuple:
    """Families with the batched serving decode loop."""
    return families_with("decode_loop")


def get_model(cfg: ModelConfig) -> ModelApi:
    return _BY_FAMILY.get(cfg.family, _TRANSFORMER)
