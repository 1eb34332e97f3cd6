"""Paged-KV continuous batching with prefix sharing (counterpart of
``repro.serve.paged``).

:class:`PagedServeRuntime` replaces :class:`~repro_torch.serve.runtime.
ServeRuntime`'s dense per-slot KV rows (``max_slots`` rows of ``max_len``
positions, mostly empty) with one global pool of fixed-size pages
(``models.transformer.init_page_pool``) and a per-slot **block table**
mapping each slot's positions to pool pages.  A slot holds
``ceil((prompt + max_new) / page_size)`` pages, and identical prompt
prefixes share pages:

* the page allocator (``kvpool.PageAllocator``) refcounts pages; page 0 is
  the sink page retired lanes scatter into;
* the radix cache (``kvpool.RadixCache``) maps page-sized token chunks to
  the pages holding their K/V.  At admission a prompt is matched against
  it; whole-page hits are retained as the request's leading block-table
  entries and only the rest of the prompt runs through prefill
  (``transformer.prefill_cached``, over a gathered copy of the shared
  pages).  Shared pages are always full, hence never written again.

The block table lives on the host (``numpy``) and is copied to the device
once per decode step.

**Exactness contract** (as in the reference): with ``max_len % page_size
== 0`` the gathered view ``pool[ptab]`` has the geometry of a dense slot
row and runs through the same ``streaming_attention`` with the same
``kv_len`` mask, and a cold prefill is the dense runtime's
``prefill_ragged`` call, so ``backend="gather"`` emits the dense runtime's
tokens.  ``backend="kernel"`` decodes through the paged-attention CUDA
kernel (``kernels.ops.paged_attention``), ``"oracle"`` through its plain
PyTorch version: the same attention summed in another order, held to the
near-tie rule against ``decode_lm``.  Every matmul, shared-prefix suffixes
included, still goes through the :class:`AnalogPack`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import PAGED_BACKENDS
from repro_torch.serve.kvpool import (SINK_PAGE, PageAllocator,
                                      PagePoolExhausted, RadixCache,
                                      full_pages, pages_needed,
                                      shareable_prefix)
from repro_torch.serve.runtime import (ServeRuntime, SlotState, _Pending,
                                       _pow2_at_least, request_key)


class PagedServeRuntime(ServeRuntime):
    """:class:`ServeRuntime` over a paged KV pool with prefix sharing.

    ``page_size``: tokens per page; ``max_len`` must be a multiple of it.
    ``num_pages``: pool size, sink page included (default ``1 + max_slots *
    max_len / page_size``, the dense runtime's capacity); a smaller pool
    makes requests wait at admission, in FIFO order.  ``prefix_cache``:
    keep completed prompts' full pages in the radix cache.  ``backend``:
    ``"gather"``, ``"kernel"`` or ``"oracle"`` (see the module docstring).
    Everything else is the dense runtime's; there is no gang mode (the
    dense runtime is the static-batching baseline).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        page_size: int = 8,
        num_pages: Optional[int] = None,
        prefix_cache: bool = True,
        backend: str = "gather",
        max_slots: int = 8,
        max_len: int = 64,
        **kw,
    ):
        if kw.get("gang"):
            raise ValueError(
                "the paged runtime has no gang mode; use the dense "
                "ServeRuntime as the static-batching baseline")
        if kw.get("attn_backend", "stream") != "stream":
            raise ValueError(
                "the paged runtime ignores attn_backend (its decode path is "
                "decode_step_paged); use backend='kernel' for the "
                "paged-attention kernel, or the dense ServeRuntime for "
                "flash decode")
        if backend not in PAGED_BACKENDS:
            raise ValueError(f"unknown paged backend {backend!r}; choose "
                             f"from {PAGED_BACKENDS}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size:
            raise ValueError(
                f"max_len={max_len} must be a multiple of "
                f"page_size={page_size}: equal geometry between the gathered "
                f"paged view and a dense slot row is what keeps paged decode "
                f"equal to the dense runtime")
        self.page_size = int(page_size)
        self.backend = backend
        self._np = max_len // self.page_size      # block-table width
        self.num_pages = (1 + max_slots * self._np if num_pages is None
                          else int(num_pages))
        if self.num_pages < 1 + self._np:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold even one "
                f"full-length request ({self._np} pages + sink)")
        api = get_model(cfg)
        if (api.init_page_pool is None or api.prefill_cached is None
                or api.decode_step_paged is None):
            raise ValueError(
                f"family {cfg.family!r} has no paged-KV support (needs "
                f"ModelApi.init_page_pool + prefill_cached + "
                f"decode_step_paged)")
        self._use_prefix_cache = bool(prefix_cache)
        super().__init__(cfg, params, max_slots=max_slots, max_len=max_len,
                         **kw)

    # -- state ------------------------------------------------------------

    def reset(self) -> None:
        self._alloc = PageAllocator(self.num_pages)
        self._radix = (RadixCache(self._alloc, self.page_size)
                       if self._use_prefix_cache else None)
        self._resv: Dict[str, Tuple[List[int], int]] = {}
        self._ptab = np.zeros((self.max_slots, self._np), np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(self.max_slots)]
        super().reset()
        self._stats.update(prefix_hits=0, prefix_tokens_reused=0,
                           cache_evictions=0, admission_stalls=0)

    def _init_layers(self):
        return self._api.init_page_pool(self.cfg, self.num_pages,
                                        self.page_size, device=self.device)

    # -- admission ---------------------------------------------------------

    def _reserve(self, req: _Pending) -> bool:
        """Claim pages for the queue head: radix-match its prompt, retain
        the shared whole-page prefix, allocate the rest.  On exhaustion,
        evict LRU cache-only pages; if still short, leave it queued."""
        ps = self.page_size
        plen = int(req.prompt.size)
        total = pages_needed(plen + req.max_new, ps)
        shared: List[int] = []
        ctx = 0
        if self._radix is not None:
            match = self._radix.match(req.prompt.tolist())
            ctx = shareable_prefix(len(match), plen, ps)
            shared = match[:ctx // ps]
            if shared:
                # take the slot's references before an eviction can drop
                # the cache's own references on these pages
                self._alloc.retain(shared)
        n_new = total - len(shared)
        if n_new > self._alloc.free_pages and self._radix is not None:
            self._stats["cache_evictions"] += self._radix.evict(n_new)
        try:
            fresh = self._alloc.alloc(n_new)
        except PagePoolExhausted:
            if shared:
                self._alloc.release(shared)
            self._stats["admission_stalls"] += 1
            return False
        pages = shared + fresh
        if self._radix is not None:
            # register the prompt's full pages now: same-batch followers
            # match them and are grouped after this request (ascending
            # ctx), so their gathers read this prefill's pool writes
            self._radix.insert(req.prompt.tolist(),
                               pages[:full_pages(plen, ps)])
        if ctx:
            self._stats["prefix_hits"] += 1
            self._stats["prefix_tokens_reused"] += ctx
        self._resv[str(req.uid)] = (pages, ctx)
        return True

    def _group_key(self, req: _Pending) -> Tuple:
        _, ctx = self._resv[str(req.uid)]
        return (ctx, self._bucket_for(req.prompt.size - ctx))

    def _free_slot(self, i: int) -> None:
        pages, self._slot_pages[i] = self._slot_pages[i], []
        if pages:
            self._alloc.release(pages)
        self._ptab[i, :] = SINK_PAGE
        super()._free_slot(i)

    # -- prefill -----------------------------------------------------------

    def _prefill_group(self, key: Tuple,
                       items: List[Tuple[_Pending, int]]) -> None:
        ctx, bucket = key
        g = min(_pow2_at_least(len(items)), self.max_slots)
        ncp = ctx // self.page_size
        suffix = np.zeros((g, bucket), np.int64)
        true_lens = np.ones((g,), np.int32)
        slots = np.full((g,), self.max_slots, np.int64)   # dummy -> dropped
        max_new = np.ones((g,), np.int32)
        keys = np.zeros((g,), np.int64)
        ctx_pages = np.zeros((g, ncp), np.int64)          # dummy -> sink
        ptabg = np.zeros((g, self._np), np.int64)
        for j, (req, slot) in enumerate(items):
            pages, rctx = self._resv.pop(str(req.uid))
            if rctx != ctx:
                raise RuntimeError(
                    f"admission group mixed cached-prefix depths: reserved "
                    f"ctx={rctx}, group ctx={ctx}")
            sfx = req.prompt[ctx:]
            suffix[j, :sfx.size] = sfx
            true_lens[j] = sfx.size
            slots[j] = slot
            max_new[j] = req.max_new
            keys[j] = request_key(self._seed, req.uid)
            ctx_pages[j] = pages[:ncp]
            ptabg[j, :len(pages)] = pages
            self._slot_pages[slot] = pages
            self._ptab[slot, :] = SINK_PAGE
            self._ptab[slot, :len(pages)] = pages
            self._slots[slot] = req
        self._paged_prefill(ctx, *(torch.as_tensor(a, device=self.device)
                                   for a in (suffix, true_lens, slots,
                                             max_new, keys, ctx_pages,
                                             ptabg)),
                            n_real=len(items))
        self._admitted(items)

    def _paged_prefill(self, ctx: int, suffix, true_lens, slots, max_new,
                       keys, ctx_pages, ptabg, *, n_real: int) -> None:
        """Prefill one group and scatter its K/V into each row's own pages;
        pad positions (and every dummy row's) go to the sink page."""
        g, s = suffix.shape
        ps = self.page_size
        pool = self._state.layers["attn"]
        if ctx == 0:
            # a cold group: the dense runtime's prefill call
            logits, pcache = self._api.prefill_ragged(
                self.cfg, self.params, suffix, true_lens=true_lens,
                pack=self.pack)
            kv = pcache["layers"]["attn"]
        else:
            # a prefix hit: a gathered copy of the shared pages as context,
            # only the suffix through the layers
            ctx_cache = {name: pool[name][:, ctx_pages].reshape(
                pool[name].shape[0], g, ctx, *pool[name].shape[3:])
                for name in ("k", "v")}
            logits, pcache = self._api.prefill_cached(
                self.cfg, self.params, suffix, true_lens=true_lens,
                ctx_lens=torch.full((g,), ctx, dtype=torch.int32,
                                    device=self.device),
                ctx_cache=ctx_cache, pack=self.pack)
            kv = {name: a[:, :, ctx:ctx + s]
                  for name, a in pcache["layers"]["attn"].items()}
        dev = self.device
        pos = ctx + torch.arange(s, device=dev)[None, :]              # (1, S)
        valid = torch.arange(s, device=dev)[None, :] < true_lens[:, None]
        pidx = torch.clamp(pos // ps, max=self._np - 1).expand(g, s)
        pids = torch.where(valid, torch.gather(ptabg, 1, pidx),
                           torch.full_like(pidx, SINK_PAGE))
        offs = (pos % ps).expand(g, s)
        for name in ("k", "v"):
            pool[name][:, pids, offs] = kv[name].to(pool[name].dtype)
        rows = slots[:n_real]
        self._state.length[rows] = (ctx + true_lens[:n_real]).to(
            self._state.length.dtype)
        self._start_rows(logits, keys, slots, max_new, n_real)

    # -- decode ------------------------------------------------------------

    def _decode_model(self, st: SlotState):
        ptab = torch.as_tensor(self._ptab, device=self.device)
        logits, cache = self._api.decode_step_paged(
            self.cfg, self.params, st.tok[:, None],
            {"pool": st.layers, "ptab": ptab, "len": st.length},
            pack=self.pack, backend=self.backend)
        return logits[:, -1], cache["pool"], cache["len"]

    # -- introspection -----------------------------------------------------

    @property
    def page_stats(self) -> Dict[str, Any]:
        """Live pool occupancy: free/used pages, cached pages, and the pages
        resident requests hold."""
        return {
            "num_pages": self.num_pages,
            "free_pages": self._alloc.free_pages,
            "used_pages": self._alloc.used_pages,
            "pages_cached": (0 if self._radix is None
                             else self._radix.pages_cached),
            "resident_pages": sum(len(p) for p in self._slot_pages),
        }

    def check(self) -> None:
        """Cross-structure invariants: allocator and radix consistency,
        block tables referencing only live pages, no page held by more slots
        than it has references."""
        self._alloc.check()
        if self._radix is not None:
            self._radix.check()
        holders: Dict[int, int] = {}
        for i, pages in enumerate(self._slot_pages):
            if self._slots[i] is None and pages:
                raise AssertionError(f"free slot {i} still owns pages")
            if len(set(pages)) != len(pages):
                raise AssertionError(f"slot {i} lists a page twice")
            for p in pages:
                if p == SINK_PAGE:
                    raise AssertionError(f"slot {i} owns the sink page")
                if self._alloc.refcount(p) < 1:
                    raise AssertionError(
                        f"slot {i} references dead page {p}")
                holders[p] = holders.get(p, 0) + 1
        for p, n in holders.items():
            if self._alloc.refcount(p) < n:
                raise AssertionError(
                    f"page {p} held by {n} slots with only "
                    f"{self._alloc.refcount(p)} references")
