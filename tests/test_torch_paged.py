"""The port's paged serving path (``repro_torch.serve.paged``, ``kvpool``,
the paged branch of the model) and the plain versions of the paged-attention
and Design-D bit-serial kernels, against the JAX package, on the CPU.

Tolerances:

* ``kvpool`` is pure Python: the port's allocator and radix cache must
  give the reference's results exactly on one op trace, and keep the
  invariants of ``tests/test_properties.py``.
* Paged attention (plain version against the reference's interpret-mode
  kernel and its oracle): the flash-decode bound, ``4 ulp(|out|) +
  kv_len * eps * max|v|`` (``tolerance.paged_attention_check``): both
  sum the same softmax terms in another order.
* Paged decode with ``backend="gather"`` equals the dense decode to the
  bit; paged serving equals dense serving token for token (the contract
  of ``tests/test_paged.py``).
* ``prefill_cached``: logits within 1e-5 relative (and 1e-5 of the logit
  scale) of the reference's on the same weights and context, the digital
  bound of ``tests/test_torch_model.py``.
* The port's paged runtime against the reference's on one exported
  analog pack: tokens identical except where the reference's top-2 logit
  gap at the first diverging step is under 1e-4 of the logit scale.
* Design-D bit-serial (plain version against the reference's oracle and
  interpret-mode kernel): ``tolerance.bitserial_check`` — within 2 ulp or
  0.25 of ``gain``, one-code flips of one bit only at a rounding edge of
  that (partition, bit)'s pre-ADC value (within 4 ulp, or with the
  reference's own value across the edge); both pre-ADC values within the
  float32 reordering bound ``rows * 2**-24 * sum |x g|``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config as j_smoke
from repro.core import analog as JA
from repro.core import errors as JE
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import transformer as JT
from repro.serve import PagedServeRuntime as JPagedServeRuntime
from repro.serve import calibrate_lm as j_calibrate
from repro.serve import kvpool as j_kvpool
from repro.serve import program_lm as j_program
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import analog as A
from repro_torch.core import errors as E
from repro_torch.hw import DIGITAL, Profile
from repro_torch.kernels import fused as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import tolerance
from repro_torch.kernels.tolerance import (BITSERIAL_GAIN, BITSERIAL_GRID,
                                           BITSERIAL_RANGE, PAGED_GRID,
                                           bitserial_case, paged_case)
from repro_torch.models import transformer as T
from repro_torch.serve import (PagedServeRuntime, SamplerConfig,
                               ServeRuntime, calibrate_lm, decode_lm,
                               program_lm)
from repro_torch.serve import kvpool
from test_torch_cuda import _ids
from test_torch_model import _export_pack, _np_tree

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
NPZ = os.path.join(ROOT, "benchmarks", "_cache", "lm_qwen1_5-4b_0.npz")
SETTINGS = dict(max_examples=30, deadline=None)


# ---------------------------------------------------------------------------
# kvpool: the reference's invariants, and one trace through both packages
# ---------------------------------------------------------------------------


@st.composite
def _alloc_ops(draw):
    n_ops = draw(st.integers(1, 40))
    return [(draw(st.sampled_from(["alloc", "retain", "release"])),
             draw(st.integers(0, 4))) for _ in range(n_ops)]


@given(num_pages=st.integers(2, 24), ops=_alloc_ops(),
       seed=st.integers(0, 2 ** 16))
@settings(**SETTINGS)
def test_page_allocator_invariants(num_pages, ops, seed):
    """Conservation, refcounts, no sink circulation, no page handed out
    twice while live — against a shadow-model allocator
    (``tests/test_properties.py::test_page_allocator_invariants``)."""
    rng = np.random.default_rng(seed)
    a = kvpool.PageAllocator(num_pages)
    model = {}
    for op, n in ops:
        live = sorted(model)
        if op == "alloc":
            try:
                got = a.alloc(n)
            except kvpool.PagePoolExhausted:
                assert n > (num_pages - 1) - len(model)
            else:
                assert len(got) == n == len(set(got))
                assert not set(got) & set(model)
                assert 0 not in got
                for p in got:
                    model[p] = 1
        elif op == "retain" and live:
            pick = [live[int(i)] for i in
                    rng.integers(0, len(live), size=min(n, len(live)))]
            a.retain(pick)
            for p in pick:
                model[p] += 1
        elif op == "release" and live:
            pick = [live[int(i)] for i in
                    rng.integers(0, len(live), size=min(n, len(live)))]
            safe, budget = [], dict(model)
            for p in pick:
                if budget[p] > 0:
                    safe.append(p)
                    budget[p] -= 1
            a.release(safe)
            for p in safe:
                model[p] -= 1
                if not model[p]:
                    del model[p]
        a.check()
        assert a.used_pages == len(model)
        assert a.free_pages == (num_pages - 1) - len(model)
        for p, r in model.items():
            assert a.refcount(p) == r
    dead = next((p for p in range(1, num_pages) if p not in model), None)
    if dead is not None:
        with pytest.raises(ValueError):
            a.release([dead])


@st.composite
def _prompts(draw):
    n = draw(st.integers(1, 8))
    return [draw(st.lists(st.integers(0, 3), min_size=1, max_size=12))
            for _ in range(n)]


@given(prompts=_prompts(), page_size=st.integers(1, 4), queries=_prompts())
@settings(**SETTINGS)
def test_radix_match_equals_brute_force(prompts, page_size, queries):
    """``RadixCache.match`` is the longest cached whole-page prefix, and the
    first inserter of a chunk owns its page
    (``tests/test_properties.py::test_radix_match_equals_brute_force``)."""
    a = kvpool.PageAllocator(512)
    r = kvpool.RadixCache(a, page_size)
    model = {}
    for toks in prompts:
        nfull = kvpool.full_pages(len(toks), page_size)
        pages = a.alloc(nfull)
        r.insert(toks, pages)
        for i in range(nfull):
            model.setdefault(tuple(toks[:(i + 1) * page_size]), pages[i])
        r.check()
        a.check()
    for q in prompts + queries:
        expect = []
        for i in range(len(q) // page_size):
            page = model.get(tuple(q[:(i + 1) * page_size]))
            if page is None:
                break
            expect.append(page)
        assert r.match(q) == expect
    assert r.pages_cached == len(model)


@given(prompts=_prompts(), page_size=st.integers(1, 3),
       pool=st.integers(4, 16), seed=st.integers(0, 2 ** 16))
@settings(**SETTINGS)
def test_radix_evict_frees_without_breaking_holders(prompts, page_size,
                                                    pool, seed):
    """Eviction releases only the cache's own references
    (``tests/test_properties.py::test_radix_evict_frees_without_breaking_holders``)."""
    rng = np.random.default_rng(seed)
    a = kvpool.PageAllocator(pool)
    r = kvpool.RadixCache(a, page_size)
    held = []
    for toks in prompts:
        nfull = kvpool.full_pages(len(toks), page_size)
        shared = r.match(toks)[:nfull]
        if shared:
            a.retain(shared)
        want = nfull - len(shared)
        if want > a.free_pages:
            r.evict(want)
        try:
            fresh = a.alloc(want)
        except kvpool.PagePoolExhausted:
            if shared:
                a.release(shared)
            continue
        pages = shared + fresh
        r.insert(toks, pages)
        if rng.integers(2):
            held.extend(pages)
        else:
            a.release(pages)
        r.check()
        a.check()
    for p in held:
        assert a.refcount(p) >= 1
    r.evict(pool)
    assert r.pages_cached == 0
    r.check()
    a.check()
    a.release(held)
    assert a.used_pages == 0 and a.free_pages == pool - 1


def _kvpool_trace(mod, seed: int):
    """One seeded trace of allocator and radix-cache operations through the
    kvpool module ``mod``; returns every observable result in order."""
    rng = np.random.default_rng(seed)
    a = mod.PageAllocator(20)
    r = mod.RadixCache(a, 3)
    held, log = [], []
    for _ in range(300):
        op = rng.integers(6)
        if op == 0:
            n = int(rng.integers(0, 5))
            try:
                pages = a.alloc(n)
            except mod.PagePoolExhausted:
                log.append(("exhausted", n))
            else:
                held.extend(pages)
                log.append(("alloc", pages))
        elif op == 1 and held:
            p = held[int(rng.integers(len(held)))]
            a.retain([p])
            held.append(p)
            log.append(("retain", p))
        elif op == 2 and held:
            p = held.pop(int(rng.integers(len(held))))
            log.append(("release", p, a.release([p])))
        elif op == 3:
            toks = rng.integers(0, 3, size=int(rng.integers(1, 13))).tolist()
            nfull = mod.full_pages(len(toks), 3)
            shared = r.match(toks)[:nfull]
            log.append(("match", shared, mod.shareable_prefix(
                len(shared), len(toks), 3)))
            if nfull <= a.free_pages:
                pages = a.alloc(nfull)
                log.append(("insert", r.insert(toks, pages)))
                held.extend(pages)
        elif op == 4:
            log.append(("evict", r.evict(int(rng.integers(0, 20)))))
        elif op == 5 and rng.integers(8) == 0:
            log.append(("clear", r.clear()))
        a.check()
        r.check()
        log.append((a.free_pages, a.used_pages, r.pages_cached,
                    mod.pages_needed(int(rng.integers(0, 40)), 3)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kvpool_trace_matches_reference(seed):
    """The port's copy of ``kvpool`` gives the reference's results, step for
    step, on the same random operation trace."""
    assert kvpool.SINK_PAGE == j_kvpool.SINK_PAGE
    assert _kvpool_trace(kvpool, seed) == _kvpool_trace(j_kvpool, seed)


# ---------------------------------------------------------------------------
# the paged-attention kernel's plain version
# ---------------------------------------------------------------------------


def _pool(k, v, pool_dtype):
    """The K/V pools in ``pool_dtype`` for both packages (both round the
    same float32 values to bfloat16 the same way)."""
    tk = torch.as_tensor(k).to(getattr(torch, pool_dtype))
    tv = torch.as_tensor(v).to(getattr(torch, pool_dtype))
    jk = jnp.asarray(k).astype(getattr(jnp, pool_dtype))
    jv = jnp.asarray(v).astype(getattr(jnp, pool_dtype))
    return tk, tv, jk, jv


@pytest.mark.parametrize("b,h,kv,hd,ps,npg,pool_dtype", PAGED_GRID,
                         ids=_ids(PAGED_GRID))
def test_plain_paged_attention_matches_jax(b, h, kv, hd, ps, npg, pool_dtype):
    """Against the reference's kernel (interpret mode) and its oracle."""
    q, k, v, ptab, kv_len = paged_case(b, h, kv, hd, ps, npg)
    tk, tv, jk, jv = _pool(k, v, pool_dtype)
    got = t_ops.paged_attention(torch.as_tensor(q), tk, tv,
                                torch.as_tensor(ptab), torch.as_tensor(kv_len))
    assert got.shape == (b, h, hd) and got.dtype == torch.float32
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(ptab), jnp.asarray(kv_len))
    for want in (j_ops.paged_attention(*jargs),
                 j_ref.paged_attention_decode(*jargs)):
        r = tolerance.paged_attention_check(
            torch.as_tensor(np.array(want)), got, tv, torch.as_tensor(ptab),
            torch.as_tensor(kv_len))
        assert r["ok"], r


def test_paged_attention_invariant_to_table_tail_padding():
    """Positions at or beyond kv_len contribute exact zeros, so the result
    cannot depend on the page ids padding the table's tail
    (``tests/test_kernels.py::test_paged_attention_invariant_to_table_tail_padding``)."""
    q, kp, vp, ptab, kv_len = (torch.as_tensor(a)
                               for a in paged_case(3, 4, 2, 8, 4, 4, seed=1))
    base = t_ops.paged_attention(q, kp, vp, ptab, kv_len)
    tab = ptab.clone()
    for i, n in enumerate(kv_len.tolist()):
        tab[i, -(-n // 4):] = (i + 5) % tab.shape[1] + 1   # garbage, non-sink
    assert torch.equal(base, t_ops.paged_attention(q, kp, vp, tab, kv_len))


def test_paged_wrappers_refuse_bad_backends_and_devices():
    from repro_torch.kernels import analog_mvm as t_mvm
    from repro_torch.kernels import paged as t_paged

    q, kp, vp, ptab, kv_len = (torch.as_tensor(a)
                               for a in paged_case(2, 2, 1, 8, 4, 2, seed=0))
    with pytest.raises(ValueError, match="backend"):
        t_ops.paged_attention(q, kp, vp, ptab, kv_len, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        t_paged.paged_attention_cuda(q, kp, vp, ptab, kv_len)
    x, gp, gm = (torch.as_tensor(a) for a in bitserial_case(2, 1, 8, 4, 4))
    lo, hi = torch.tensor(-20.0), torch.tensor(20.0)
    with pytest.raises(ValueError, match="backend"):
        t_ops.analog_mvm_bitserial(x, gp, gm, n_bits=4, adc_lo=lo, adc_hi=hi,
                                   adc_bits=8, gain=1.0, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        t_mvm.analog_mvm_bitserial_cuda(x, gp, gm, lo, hi, n_bits=4,
                                        adc_bits=8, gain=1.0)


# ---------------------------------------------------------------------------
# the model layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    cfg = get_smoke_config("qwen1.5-4b")
    params = interop.load_params_npz(NPZ, device="cpu")
    return cfg, params


def _pool_from_prefill(cfg, pcache, ptab, num_pages, ps):
    """A page pool holding each row's prefill K/V at its block-table pages."""
    pool = T.init_page_pool(cfg, num_pages, ps, device="cpu")
    s = pcache["layers"]["attn"]["k"].shape[2]
    for name in ("k", "v"):
        src = pcache["layers"]["attn"][name]
        for b in range(ptab.shape[0]):
            for t in range(s):
                pool["attn"][name][:, ptab[b, t // ps], t % ps] = src[:, b, t]
    return pool


@pytest.mark.parametrize("analog", [False, True], ids=["digital", "analog"])
def test_decode_step_paged_gather_equals_dense(lm, analog):
    """``decode_step_paged(backend="gather")`` over a shuffled block table
    gives the dense ``decode_step``'s logits to the bit, step after step."""
    cfg, params = lm
    pack = None
    if analog:
        spec = A.design_a(error=E.state_proportional(0.05), fused="kernel")
        calib = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 12))
        pack = calibrate_lm(cfg, params, program_lm(cfg, params, spec, seed=3),
                            torch.as_tensor(calib))
    b, s, ps, npg = 3, 8, 4, 4
    rng = np.random.default_rng(2)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, size=(b, s)))
    lens = torch.tensor([8, 5, 3], dtype=torch.int32)
    logits, pcache = T.prefill_ragged(cfg, params, prompts, true_lens=lens,
                                      pack=pack)
    dense = T.init_cache(cfg, b, npg * ps, device="cpu")
    dense["len"] = torch.zeros((b,), dtype=torch.int32)
    T.cache_slot_insert(dense, pcache, torch.arange(b))
    ptab = torch.as_tensor(1 + rng.permutation(b * npg).reshape(b, npg))
    pool = _pool_from_prefill(cfg, pcache, ptab, 1 + b * npg, ps)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    paged = {"pool": pool, "ptab": ptab, "len": dense["len"].clone()}
    for _ in range(4):
        lg_d, dense = T.decode_step(cfg, params, tok, dense, pack=pack)
        lg_p, paged = T.decode_step_paged(cfg, params, tok, paged, pack=pack,
                                          backend="gather")
        assert torch.equal(lg_d, lg_p)
        tok = torch.argmax(lg_d[:, -1], dim=-1)[:, None]


def test_prefill_cached_matches_reference(lm):
    """The suffix prefill over a cached context against the reference's on
    the same weights and context (and the context copy is never written
    at its cached positions)."""
    cfg, params = lm
    j_cfg = j_smoke("qwen1.5-4b")
    j_params = jax.tree.map(jnp.asarray, _np_tree(NPZ))
    rng = np.random.default_rng(3)
    ctx_len, b, s = 8, 2, 8
    prefix = rng.integers(0, cfg.vocab, size=(b, ctx_len))
    _, pc = T.prefill_ragged(cfg, params, torch.as_tensor(prefix),
                             true_lens=torch.full((b,), ctx_len))
    ctx_cache = {n: a.clone() for n, a in pc["layers"]["attn"].items()}
    kept = {n: a.clone() for n, a in ctx_cache.items()}
    suffix = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    true_lens = np.array([8, 5], np.int32)
    ctx_lens = np.full((b,), ctx_len, np.int32)
    lg_t, cache_t = T.prefill_cached(
        cfg, params, torch.as_tensor(suffix),
        true_lens=torch.as_tensor(true_lens),
        ctx_lens=torch.as_tensor(ctx_lens), ctx_cache=ctx_cache)
    lg_j, cache_j = JT.prefill_cached(
        j_cfg, j_params, jnp.asarray(suffix), true_lens=jnp.asarray(true_lens),
        ctx_lens=jnp.asarray(ctx_lens),
        ctx_cache={n: jnp.asarray(a.numpy()) for n, a in kept.items()})
    lg_j = np.asarray(lg_j)
    scale = np.abs(lg_j).max()
    np.testing.assert_allclose(lg_t.numpy(), lg_j, rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_array_equal(cache_t["len"].numpy(),
                                  np.asarray(cache_j["len"]))
    for n in ("k", "v"):
        assert torch.equal(ctx_cache[n], kept[n])
        got = cache_t["layers"]["attn"][n][:, :, :ctx_len + s]
        assert torch.equal(got[:, :, :ctx_len], kept[n])
        want = np.asarray(cache_j["layers"]["attn"][n])[:, :, :ctx_len + s]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the paged runtime: tests/test_paged.py's contracts, applied to the port
# ---------------------------------------------------------------------------


def _mixed_trace(cfg, n, seed=0, lens=(3, 14), new=(2, 6), prefix_len=9):
    """Requests with heavy prefix sharing: every other prompt opens with
    the same ``prefix_len`` tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab, size=prefix_len).astype(np.int32)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(*lens))
        p = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        if i % 2 == 0:
            k = min(prefix_len, plen - 1)
            p[:k] = prefix[:k]
        reqs.append((p, int(rng.integers(*new))))
    return reqs


def _serve(rt, reqs):
    for i, (p, n) in enumerate(reqs):
        rt.submit(p, max_new_tokens=n, uid=f"r{i}")
    return rt.run()


def _agreement(cfg, params, reqs, *, max_slots, max_len, page_size, **kw):
    """Token agreement of the paged runtime with the dense one on ``reqs``
    (the reference's ``sweep.serve_eval.paged_runtime_agreement``)."""
    dense = ServeRuntime(cfg, params, max_slots=max_slots, max_len=max_len,
                         **kw)
    paged = PagedServeRuntime(cfg, params, max_slots=max_slots,
                              max_len=max_len, page_size=page_size, **kw)
    ref, got = _serve(dense, reqs), _serve(paged, reqs)
    paged.check()
    agree = sum(int((ref[u] == got[u]).sum()) for u in ref)
    return agree / sum(r.size for r in ref.values())


@pytest.fixture(scope="module")
def ref_pack(lm):
    """A Design-A pack programmed and calibrated by the reference, and the
    same pack in the port."""
    cfg, _ = lm
    j_cfg = j_smoke("qwen1.5-4b")
    j_params = jax.tree.map(jnp.asarray, _np_tree(NPZ))
    calib = np.random.default_rng(4).integers(0, cfg.vocab, size=(4, 16))
    j_spec = JA.design_a(error=JE.state_independent(0.05), fused="oracle")
    j_pack = j_program(j_cfg, j_params, j_spec, jax.random.PRNGKey(5))
    j_pack = jax.jit(lambda p, pk, c: j_calibrate(j_cfg, p, pk, c))(
        j_params, j_pack, jnp.asarray(calib))
    t_spec = A.design_a(error=E.state_independent(0.05), fused="kernel")
    t_pack = interop.pack_from_numpy(_export_pack(j_pack), t_spec, cfg,
                                     device="cpu")
    return j_cfg, j_params, j_pack, t_pack


def test_paged_matches_dense_digital_greedy(lm):
    cfg, params = lm
    assert _agreement(cfg, params, _mixed_trace(cfg, 8), max_slots=4,
                      max_len=24, page_size=4) == 1.0


def test_paged_matches_dense_seeded_sampling(lm):
    """Per-request keys fold from uids in both runtimes, so sampled streams
    coincide exactly."""
    cfg, params = lm
    assert _agreement(
        cfg, params, _mixed_trace(cfg, 6, seed=1), max_slots=4, max_len=24,
        page_size=4, sampler=SamplerConfig(kind="temperature",
                                           temperature=0.8),
        seed=11) == 1.0


def test_paged_matches_dense_analog_pack(lm, ref_pack):
    """On a pack programmed and calibrated by the reference."""
    cfg, params = lm
    reqs = _mixed_trace(cfg, 5, seed=2, lens=(5, 7), new=(4, 6))
    assert _agreement(cfg, params, reqs, pack=ref_pack[3], max_slots=2,
                      max_len=16, page_size=4) == 1.0


def test_paged_matches_dense_hetero_profile(lm):
    cfg, params = lm
    spec8 = A.design_a(error=E.state_proportional(0.05), fused="kernel")
    profile = Profile.by_class(attn=spec8, mlp=spec8, head=DIGITAL)
    calib = np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 16))
    pack = calibrate_lm(cfg, params, program_lm(cfg, params, profile, seed=5),
                        torch.as_tensor(calib))
    reqs = _mixed_trace(cfg, 4, seed=3, lens=(5, 7), new=(4, 6))
    assert _agreement(cfg, params, reqs, pack=pack, max_slots=2, max_len=16,
                      page_size=4) == 1.0


def test_prefix_hit_bit_identical_to_cold(lm):
    """The same trace with the radix cache on and off emits identical
    tokens."""
    cfg, params = lm
    reqs = _mixed_trace(cfg, 8, seed=5)
    outs = {}
    for cached in (False, True):
        rt = PagedServeRuntime(cfg, params, max_slots=4, max_len=24,
                               page_size=4, prefix_cache=cached)
        outs[cached] = _serve(rt, reqs)
        rt.check()
        hits = rt.stats["prefix_hits"]
        assert hits > 0 if cached else hits == 0
    for uid in outs[False]:
        np.testing.assert_array_equal(outs[False][uid], outs[True][uid])


def test_eviction_readmission_replay_identity(lm):
    """A pool too small to keep everything evicts; a resubmitted prompt
    replays identically whether its pages survived or were recomputed."""
    cfg, params = lm
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=9).astype(np.int32)
               for _ in range(4)]
    rt = PagedServeRuntime(cfg, params, max_slots=2, max_len=16,
                           page_size=4, num_pages=9)
    first = {}
    for i, p in enumerate(prompts):
        first[i] = _serve(rt, [(p, 4)])["r0"]
        rt.check()
    assert rt.stats["cache_evictions"] > 0
    for i, p in enumerate(prompts):
        uid = rt.submit(p, max_new_tokens=4, uid=f"again{i}")
        np.testing.assert_array_equal(rt.run()[uid], first[i])
        rt.check()


@pytest.mark.parametrize("paged", [False, True])
def test_retired_at_prefill_frees_capacity_same_step(lm, paged):
    """A burst of 1-token requests retires at prefill and drains in one
    scheduler step with no decode step, slots and pages recycled."""
    cfg, params = lm
    rng = np.random.default_rng(7)
    kw = dict(max_slots=4, max_len=16)
    rt = (PagedServeRuntime(cfg, params, page_size=4, **kw) if paged
          else ServeRuntime(cfg, params, **kw))
    for i in range(12):
        rt.submit(rng.integers(0, cfg.vocab, size=5).astype(np.int32),
                  max_new_tokens=1, uid=f"b{i}")
    done = rt.step()
    assert len(done) == 12 and rt.idle
    assert rt.stats["decode_steps"] == 0
    if paged:
        rt.check()
        assert rt.page_stats["resident_pages"] == 0


def test_pool_backpressure_preserves_fifo(lm):
    """When the pool cannot hold the queue head, admission stalls (the
    request is not skipped) and resumes as capacity frees."""
    cfg, params = lm
    rng = np.random.default_rng(8)
    rt = PagedServeRuntime(cfg, params, max_slots=4, max_len=16,
                           page_size=4, num_pages=9, prefix_cache=False)
    reqs = [(rng.integers(0, cfg.vocab, size=10).astype(np.int32), 4)
            for _ in range(5)]
    out = _serve(rt, reqs)
    rt.check()
    assert sorted(out) == sorted(f"r{i}" for i in range(5))
    assert all(v.size == 4 for v in out.values())
    assert rt.stats["admission_stalls"] > 0
    assert rt.page_stats["free_pages"] == rt.num_pages - 1


def test_paged_validation_errors(lm):
    cfg, params = lm
    with pytest.raises(ValueError, match="multiple of"):
        PagedServeRuntime(cfg, params, max_len=30, page_size=4)
    with pytest.raises(ValueError, match="gang"):
        PagedServeRuntime(cfg, params, max_len=16, page_size=4, gang=True)
    with pytest.raises(ValueError, match="backend"):
        PagedServeRuntime(cfg, params, max_len=16, page_size=4,
                          backend="pallas")
    with pytest.raises(ValueError, match="attn_backend"):
        PagedServeRuntime(cfg, params, max_len=16, page_size=4,
                          attn_backend="flash")
    with pytest.raises(ValueError, match="num_pages"):
        PagedServeRuntime(cfg, params, max_len=16, page_size=4, num_pages=3)
    with pytest.raises(ValueError, match="page_size"):
        PagedServeRuntime(cfg, params, max_len=16, page_size=0)
    rt = PagedServeRuntime(cfg, params, max_len=16, page_size=4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        rt.submit(np.arange(4, dtype=np.int32) % cfg.vocab, max_new_tokens=0)
    with pytest.raises(ValueError, match="not both"):
        PagedServeRuntime(cfg, params, max_len=16, page_size=4,
                          pack=object(), manager=object())
    with pytest.raises(ValueError, match="need a manager"):
        PagedServeRuntime(cfg, params, max_len=16, page_size=4,
                          clock=object())


def test_kernel_backend_on_cpu_runs_the_plain_version(lm, ref_pack):
    """``backend="kernel"`` on CPU tensors takes the kernel's plain version
    (no launch), serves exactly as ``"oracle"``, and agrees with
    ``decode_lm`` up to near ties."""
    cfg, params = lm
    pack = ref_pack[3]
    reqs = _mixed_trace(cfg, 4, seed=9, lens=(5, 7), new=(3, 5))
    t_fused.reset_launch_counts()
    outs = {}
    for be in ("kernel", "oracle"):
        rt = PagedServeRuntime(cfg, params, pack=pack, max_slots=2,
                               max_len=16, page_size=8, backend=be)
        outs[be] = _serve(rt, reqs)
        rt.check()
    assert not any(t_fused.LAUNCHES.values())
    for i, (p, n) in enumerate(reqs):
        got = outs["kernel"][f"r{i}"]
        np.testing.assert_array_equal(got, outs["oracle"][f"r{i}"])
        ref = decode_lm(cfg, params, torch.as_tensor(p)[None], n,
                        pack=pack)[0].numpy()
        diff = np.nonzero(ref != got)[0]
        if diff.size:
            seq = torch.as_tensor(np.concatenate([p, ref[:diff[0]]]))[None]
            lg = T.forward(cfg, params, seq, pack=pack)[0][0, -1]
            top2 = torch.topk(lg, 2).values
            assert float(top2[0] - top2[1]) < 1e-4 * float(lg.abs().max())


def test_paged_runtime_matches_reference_runtime(lm, ref_pack):
    """The port's paged runtime against the reference's on the same
    exported pack and trace: tokens identical except at a near tie of the
    reference's logits."""
    cfg, params = lm
    j_cfg, j_params, j_pack, t_pack = ref_pack
    reqs = _mixed_trace(cfg, 4, seed=10, lens=(5, 7), new=(3, 5))
    kw = dict(max_slots=2, max_len=16, page_size=4)
    t_rt = PagedServeRuntime(cfg, params, pack=t_pack, **kw)
    j_rt = JPagedServeRuntime(j_cfg, j_params, pack=j_pack, **kw)
    got, want = _serve(t_rt, reqs), _serve(j_rt, reqs)
    assert t_rt.stats["prefix_hits"] == j_rt.stats["prefix_hits"] > 0
    for i, (p, _) in enumerate(reqs):
        a, b = got[f"r{i}"], want[f"r{i}"]
        assert a.shape == b.shape
        diff = np.nonzero(a != b)[0]
        if diff.size == 0:
            continue
        seq = np.concatenate([p, b[:diff[0]]])[None]
        lg = np.asarray(JT.forward(j_cfg, j_params, jnp.asarray(seq),
                                   pack=j_pack, remat=False)[0])[0, -1]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < 1e-4 * np.abs(lg).max(), (
            f"request {i} leaves the reference away from a near tie")


# ---------------------------------------------------------------------------
# the Design-D bit-serial kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,p,rows,n,n_bits", BITSERIAL_GRID,
                         ids=_ids(BITSERIAL_GRID))
def test_plain_bitserial_matches_jax(m, p, rows, n, n_bits):
    """Against the reference's oracle and its interpret-mode kernel.  The
    port sums each bit's dot in ascending row order, the reference in its
    BLAS's order: the pre-ADC values must agree within the float32
    reordering bound, and a one-code flip is explained where the
    reference's own value lies across the edge."""
    x, gp, gm = bitserial_case(m, p, rows, n, n_bits)
    lo, hi = (np.float32(v) for v in BITSERIAL_RANGE)
    kw = dict(n_bits=n_bits, adc_bits=8, gain=BITSERIAL_GAIN)
    tx, tgp, tgm = (torch.as_tensor(a) for a in (x, gp, gm))
    got = t_ops.analog_mvm_bitserial(tx, tgp, tgm, adc_lo=torch.tensor(lo),
                                     adc_hi=torch.tensor(hi), **kw)
    assert got.shape == (m, n) and got.dtype == torch.float32
    mag = np.abs(x).astype(np.int64)
    planes = np.stack([((mag >> b) & 1) * np.sign(x) for b in range(n_bits)],
                      axis=1).astype(np.float32)              # (M, B, P, rows)
    v_ref = np.array(jnp.einsum("mbpr,prn->pbmn", jnp.asarray(planes),
                                jnp.asarray(gp - gm),
                                precision=jax.lax.Precision.HIGHEST))
    v = t_ref.fused_pre_adc(tx, tgp[None], tgm[None], n_bits)[:, 0].numpy()
    reorder = rows * 2.0 ** -24 * np.einsum(
        "mbpr,prn->pbmn", np.abs(planes).astype(np.float64),
        np.abs(gp - gm).astype(np.float64))
    assert (np.abs(v.astype(np.float64) - v_ref) <= reorder).all()
    jargs = [jnp.asarray(a) for a in (x, gp, gm)]
    for want in (j_ref.analog_mvm_bitserial(*jargs, adc_lo=lo, adc_hi=hi,
                                            **kw),
                 j_ops.analog_mvm_bitserial(*jargs, adc_lo=jnp.float32(lo),
                                            adc_hi=jnp.float32(hi), **kw)):
        res = tolerance.bitserial_check(
            torch.as_tensor(np.array(want)), got, tx, tgp, tgm, lo, hi,
            BITSERIAL_GAIN, adc_bits=8, n_bits=n_bits,
            v_other=torch.as_tensor(v_ref))
        assert res["ok"], res


def test_plain_bitserial_takes_one_slice_stacks():
    """(S=1, P, rows, N) stacks take the same path as (P, rows, N); more
    slices are refused."""
    x, gp, gm = (torch.as_tensor(a) for a in bitserial_case(3, 2, 16, 5, 7))
    kw = dict(n_bits=7, adc_lo=torch.tensor(-20.0), adc_hi=torch.tensor(20.0),
              adc_bits=8, gain=BITSERIAL_GAIN)
    flat = t_ops.analog_mvm_bitserial(x, gp, gm, **kw)
    assert torch.equal(t_ops.analog_mvm_bitserial(x, gp[None], gm[None], **kw),
                       flat)
    with pytest.raises(ValueError, match="unsliced"):
        t_ops.analog_mvm_bitserial(x, torch.stack([gp, gp]),
                                   torch.stack([gm, gm]), **kw)
