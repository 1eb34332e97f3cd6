"""Model registry (counterpart of ``repro.models.registry``): family ->
entry points.  Only the dense family is ported; the others raise and are
ROADMAP queue A item 10."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.config import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init_params: Callable
    forward: Callable          # (cfg, params, tokens, **kw) -> (logits, aux)
    prefill: Callable          # (cfg, params, tokens, max_len, **kw)
    decode_step: Callable      # (cfg, params, token, cache, **kw)
    init_cache: Callable       # (cfg, batch, max_len, *, device)
    decode_loop: Optional[Callable] = None
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

_BY_FAMILY = {"dense": _TRANSFORMER}


def get_model(cfg: ModelConfig) -> ModelApi:
    api = _BY_FAMILY.get(cfg.family)
    if api is None or cfg.rwkv or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            f"port serves {sorted(_BY_FAMILY)} (ROADMAP queue A item 10)")
    return api
