"""The port's other model families (moe, vlm, ssm/rwkv, hybrid, audio)
against the JAX reference, on identical inputs built once in numpy and
the reference's parameters and packs carried across with
``repro_torch.interop``.

* Recurrences: ``chunked_decay_recurrence`` (chunks 4, 16 and 64, with and
  without an initial state), ``decay_recurrence_naive`` and
  ``decay_step``, in the rwkv (bonus ``u``) and mamba (current token
  included) modes, float32, within 1e-5 relative (of each output's
  largest magnitude near zero) of the reference; and the port's chunked form within the reference's own
  bound of its naive one (rtol 3e-4, atol 5e-5).
* Blocks: ``rwkv_time_mix``/``rwkv_channel_mix`` and ``mamba_block`` in
  prefill and decode, outputs and carried states within 1e-5 relative;
  ``moe_block`` with equal keep/drop masks, ``lb_loss`` and ``drop_frac``,
  also where the capacity overflows, and against ``moe_block_dense_ref``.
* Models, the smoke config of every architecture (``ARCH_IDS``, the
  dense ones too): forward logits within 1e-5
  of the logit scale, prefill/decode against the teacher-forced forward
  under the reference's tolerance (``tests/test_arch_smoke.py``, rtol
  2e-2) and within 1e-5 of the reference's prefill and decode logits,
  greedy tokens identical.
* Analog, for rwkv, both MoE configs and internvl2: a Design-A
  ``fused="oracle"`` pack programmed and calibrated by the reference
  (internvl2 with its prefix embeddings); integer codes equal; the port's
  calibration of that pack within 1e-5 relative of the reference's
  ranges; analog logits within 2 ulp or 0.25 of the head's dequant step
  away from reference-rounding flips (``tests/test_torch_model.py``'s
  bound); ``decode_lm`` tokens identical but at near ties.
* Every raise of the families' serving paths, with the reference's
  reason, in both packages.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import analog as JA
from repro.core import errors as JE
from repro.models import mlp as JMLP
from repro.models import recurrent as JR
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.registry import get_model as j_model
from repro.serve import analog_engine as JAE
from repro_torch import interop
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import analog as TA
from repro_torch.core import errors as TE
from repro_torch.models import mlp as TMLP
from repro_torch.models import recurrent as TR
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.registry import get_model as t_model
from repro_torch.serve import analog_engine as TAE

from test_torch_model import _export_pack, _head_grid

FAMILY_ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b", "internvl2-26b",
                "rwkv6-3b", "zamba2-7b", "whisper-large-v3"]
ANALOG_ARCHS = ["rwkv6-3b", "qwen3-moe-235b-a22b", "arctic-480b",
                "internvl2-26b"]


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=rel, atol=rel * scale)


def _layer0(tree):
    return jax.tree.map(lambda a: np.asarray(a[0]), tree)


# ---------------------------------------------------------------------------
# recurrences
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rec_inputs():
    rng = np.random.default_rng(0)
    b, s, h, dk, dv = 2, 37, 3, 8, 5
    f = np.float32
    r = (rng.standard_normal((b, s, h, dk)) * 0.5).astype(f)
    k = (rng.standard_normal((b, s, h, dk)) * 0.5).astype(f)
    v = (rng.standard_normal((b, s, h, dv)) * 0.5).astype(f)
    lw = (-np.exp(rng.standard_normal((b, s, h, dk)) * 0.5)).astype(f)
    u = (rng.standard_normal((h, dk)) * 0.3).astype(f)
    s0 = (rng.standard_normal((b, h, dk, dv)) * 0.5).astype(f)
    return r, k, v, lw, u, s0


@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
@pytest.mark.parametrize("fn", ["chunked", "naive", "step"])
def test_recurrence_matches_reference(fn, mode):
    r, k, v, lw, u, s0 = _rec_inputs()
    u = u if mode == "rwkv" else None
    uj, ut = (None, None) if u is None else (jnp.asarray(u), _t(u))
    if fn == "step":
        yj, sj = JR.decay_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0],
                               jnp.asarray(s0), u=uj)
        yt, st = TR.decay_step(_t(r[:, 0]), _t(k[:, 0]), _t(v[:, 0]),
                               _t(lw[:, 0]), _t(s0), u=ut)
        runs = [((yj, sj), (yt, st))]
    elif fn == "naive":
        runs = [(JR.decay_recurrence_naive(r, k, v, lw, u=uj, s0=s0j),
                 TR.decay_recurrence_naive(_t(r), _t(k), _t(v), _t(lw), u=ut,
                                           s0=s0t))
                for s0j, s0t in ((None, None), (jnp.asarray(s0), _t(s0)))]
    else:
        runs = [(JR.chunked_decay_recurrence(r, k, v, lw, u=uj, s0=s0j,
                                             chunk=c),
                 TR.chunked_decay_recurrence(_t(r), _t(k), _t(v), _t(lw),
                                             u=ut, s0=s0t, chunk=c))
                for c in (4, 16, 64)
                for s0j, s0t in ((None, None), (jnp.asarray(s0), _t(s0)))]
    for (yj, sj), (yt, st) in runs:
        assert yt.dtype == torch.float32 and st.dtype == torch.float32
        _close(yt, yj)
        _close(st, sj)


@pytest.mark.parametrize("mode", ["rwkv", "mamba"])
def test_chunked_recurrence_matches_naive_in_port(mode):
    """The reference's own contract (``tests/test_substrate.py``)."""
    r, k, v, lw, u, _ = (_t(a) for a in _rec_inputs())
    u = u if mode == "rwkv" else None
    y2, s2 = TR.decay_recurrence_naive(r, k, v, lw, u=u)
    for chunk in (4, 16, 64):
        y1, s1 = TR.chunked_decay_recurrence(r, k, v, lw, u=u, chunk=chunk)
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=3e-4,
                                   atol=3e-5)
        np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=3e-4,
                                   atol=5e-5)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_rwkv_mixes_match_reference(phase):
    jc, tc = j_smoke("rwkv6-3b"), t_smoke("rwkv6-3b")
    p = _layer0(JS.init_rwkv(jax.random.PRNGKey(3), jc, 1, jnp.float32))
    pt = interop.params_from_numpy(p, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, jc.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    yj, stj = JS.rwkv_time_mix(p, jnp.asarray(x), jc, state=None,
                               decode=False)
    yt, stt = TS.rwkv_time_mix(pt, _t(x), tc, state=None, decode=False)
    cj, ctj = JS.rwkv_channel_mix(p, jnp.asarray(x), state=None,
                                  decode=False)
    ct, ctt = TS.rwkv_channel_mix(pt, _t(x), state=None, decode=False)
    if phase == "decode":
        sj, st = {**stj, **ctj}, {**stt, **ctt}
        yj, stj = JS.rwkv_time_mix(p, jnp.asarray(x1), jc, state=sj,
                                   decode=True)
        yt, stt = TS.rwkv_time_mix(pt, _t(x1), tc, state=st, decode=True)
        cj, ctj = JS.rwkv_channel_mix(p, jnp.asarray(x1), state=sj,
                                      decode=True)
        ct, ctt = TS.rwkv_channel_mix(pt, _t(x1), state=st, decode=True)
    for got, want in ((yt, yj), (ct, cj), (stt["wkv"], stj["wkv"]),
                      (stt["shift_t"], stj["shift_t"]),
                      (ctt["shift_c"], ctj["shift_c"])):
        _close(got, want)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_mamba_block_matches_reference(phase):
    jc, tc = j_smoke("zamba2-7b"), t_smoke("zamba2-7b")
    p = _layer0(JS.init_mamba(jax.random.PRNGKey(4), jc, 1, jnp.float32))
    # a_log and dt_bias start at 0: move them so the decay varies by head
    rng = np.random.default_rng(2)
    p["a_log"] = (rng.standard_normal(p["a_log"].shape) * 0.5) \
        .astype(np.float32)
    p["dt_bias"] = (rng.standard_normal(p["dt_bias"].shape) * 0.5) \
        .astype(np.float32)
    pt = interop.params_from_numpy(p, device="cpu")
    x = rng.standard_normal((2, 70, jc.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    yj, sj = JS.mamba_block(p, jnp.asarray(x), jc)
    yt, st = TS.mamba_block(pt, _t(x), tc)
    if phase == "decode":
        yj, sj = JS.mamba_block(p, jnp.asarray(x1), jc, state=sj,
                                decode=True)
        yt, st = TS.mamba_block(pt, _t(x1), tc, state=st, decode=True)
    _close(yt, yj)
    _close(st["ssm"], sj["ssm"])
    _close(st["conv"], sj["conv"])


def _moe_cfg(capacity_factor):
    from repro.config import ModelConfig as JCfg
    from repro_torch.config import ModelConfig as TCfg

    kw = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
              n_kv_heads=2, d_ff=32, vocab=64, n_experts=4, top_k=2,
              moe_d_ff=32, capacity_factor=capacity_factor)
    return JCfg(**kw), TCfg(**kw)


def _reference_keep(p, x, cfg):
    """The reference's keep mask, by its own lines (``mlp.py:87-107``)."""
    xt = jnp.asarray(x).reshape(-1, cfg.d_model)
    gates = jax.nn.softmax(xt @ p["router"], axis=-1)
    _, topi = jax.lax.top_k(gates, cfg.top_k)
    eid = topi.reshape(-1)
    onehot = jax.nn.one_hot(eid, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return np.asarray(pos < JMLP.moe_capacity(xt.shape[0], cfg))


@pytest.mark.parametrize("case", ["fits", "overflows"])
def test_moe_block_matches_reference(case):
    cf, s = (4.0, 8) if case == "fits" else (0.25, 32)
    jc, tc = _moe_cfg(cf)
    p = _layer0(JMLP.init_moe(jax.random.PRNGKey(0), jc, 1, jnp.float32))
    pt = interop.params_from_numpy(p, device="cpu")
    x = np.random.default_rng(5).standard_normal((2, s, 16)) \
        .astype(np.float32)
    aux_j, aux_t = {}, {}
    yj, lbj = JMLP.moe_block(p, jnp.asarray(x), jc, aux=aux_j)
    yt, lbt = TMLP.moe_block(pt, _t(x), tc, aux=aux_t)
    _, _, topi = TMLP._route(_t(x).reshape(-1, 16), pt["router"], tc.top_k)
    keep, _ = TMLP._dispatch(topi, tc.n_experts,
                             TMLP.moe_capacity(x.shape[0] * s, tc))
    want_keep = _reference_keep(p, x, jc)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert (case == "fits") == bool(want_keep.all())
    _close(yt, yj)
    np.testing.assert_allclose(float(lbt), float(lbj), rtol=1e-6)
    assert float(aux_t["moe/lb_loss"]) == float(lbt)
    assert float(aux_t["moe/drop_frac"]) == float(aux_j["moe/drop_frac"])
    assert (float(aux_t["moe/drop_frac"]) > 0) == (case == "overflows")


def test_moe_block_matches_dense_ref():
    _, tc = _moe_cfg(4.0)       # capacity = n_experts: nothing drops
    p = TMLP.init_moe(torch.Generator().manual_seed(0), tc, 1, "cpu")
    p = {n: w[0] for n, w in p.items()}
    x = torch.randn((2, 8, 16), generator=torch.Generator().manual_seed(1))
    y, lb = TMLP.moe_block(p, x, tc)
    np.testing.assert_allclose(y.numpy(),
                               TMLP.moe_block_dense_ref(p, x, tc).numpy(),
                               rtol=2e-4, atol=2e-5)
    assert float(lb) > 0.0


# ---------------------------------------------------------------------------
# models at their smoke configs
# ---------------------------------------------------------------------------

B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _family(arch):
    jc, tc = j_smoke(arch), t_smoke(arch)
    jp = jax.jit(functools.partial(j_model(jc).init_params, jc))(
        jax.random.PRNGKey(0))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab, size=(B, S)).astype(np.int32)
    pre = None
    if jc.frontend:
        pre = (rng.standard_normal((B, jc.n_frontend_tokens, jc.d_model))
               * 0.02).astype(np.float32)
    return jc, tc, jp, tp, tokens, pre


def _kw(pre, torch_side):
    if pre is None:
        return {}
    return {"prefix_embeds": _t(pre) if torch_side else jnp.asarray(pre)}


def test_interop_carries_every_family_tree():
    for arch in FAMILY_ARCHS:
        _, _, jp, tp, _, _ = _family(arch)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            node = tp
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_family_forward_logits_match_reference(arch):
    jc, tc, jp, tp, tokens, pre = _family(arch)
    lj = j_model(jc).forward(jc, jp, jnp.asarray(tokens), **_kw(pre, False))[0]
    lt = t_model(tc).forward(tc, tp, _t(tokens), **_kw(pre, True))[0]
    assert lt.shape == (B, S, tc.vocab) and bool(torch.isfinite(lt).all())
    _close(lt, lj)


def _parent_lookup(arch):
    """The lookup zamba2 and whisper made before it went through
    ``sharding.perf.local_embedding`` (``embed[tokens]``), as the module's
    ``_embed`` it replaces."""
    from repro_torch.models import encdec as TED
    from repro_torch.models import hybrid as THY

    if arch == "zamba2-7b":
        return THY, lambda cfg, params, tokens: params["embed"][
            TT._tokens(params, tokens)].to(TT.compute_dtype(cfg))
    return TED, lambda params, tokens: params["embed"][tokens]


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-large-v3"])
def test_plain_lookup_is_the_indexed_table(arch, monkeypatch):
    """On plain tensors the lookup through ``local_embedding`` and
    ``batch_rows`` is ``embed[tokens]`` to the bit: the forward's logits,
    prefill's and a decode step's are ``torch.equal`` to those of the
    indexed table's lookup."""
    _, tc, _, tp, tokens, pre = _family(arch)
    api = t_model(tc)

    def run():
        lf = api.forward(tc, tp, _t(tokens), **_kw(pre, True))[0]
        lp, cache = api.prefill(tc, tp, _t(tokens), S + 4, **_kw(pre, True))
        ld, _ = api.decode_step(tc, tp, lp[:, -1].argmax(-1)[:, None], cache)
        return lf, lp, ld

    got = run()
    module, lookup = _parent_lookup(arch)
    monkeypatch.setattr(module, "_embed", lookup)
    want = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_family_prefill_decode_matches_forward(arch):
    jc, tc, jp, tp, tokens, pre = _family(arch)
    api = t_model(tc)
    lf = api.forward(tc, tp, _t(tokens), **_kw(pre, True))[0]
    lp, cache = api.prefill(tc, tp, _t(tokens), S + 4, **_kw(pre, True))
    np.testing.assert_allclose(lp[:, 0].numpy(), lf[:, -1].numpy(),
                               rtol=2e-2, atol=2e-3)
    nt = torch.argmax(lp, -1).to(torch.int32)
    ld, cache = api.decode_step(tc, tp, nt, cache)
    lf2 = api.forward(tc, tp, torch.cat([_t(tokens), nt], 1),
                      **_kw(pre, True))[0]
    np.testing.assert_allclose(ld[:, 0].numpy(), lf2[:, -1].numpy(),
                               rtol=2e-2, atol=3e-3)
    # and the same steps against the reference's
    japi = j_model(jc)
    lpj, cj = japi.prefill(jc, jp, jnp.asarray(tokens), S + 4,
                           **_kw(pre, False))
    _close(lp, lpj)
    np.testing.assert_array_equal(nt.numpy(),
                                  np.asarray(jnp.argmax(lpj, -1)))
    ldj, _ = japi.decode_step(jc, jp, jnp.asarray(nt.numpy()), cj)
    _close(ld, ldj)


def _greedy(api, cfg, params, tokens, n_new, pre, torch_side):
    """Greedy tokens through prefill and decode_step (the families without
    a batched decode loop)."""
    lg, cache = api.prefill(cfg, params, tokens, tokens.shape[1] + n_new,
                            **_kw(pre, torch_side))
    out = []
    for _ in range(n_new):
        nxt = lg[:, -1].argmax(-1)
        out.append(np.asarray(nxt))
        nxt = nxt[:, None]
        if torch_side:
            nxt = nxt.to(torch.int32)
        lg, cache = api.decode_step(cfg, params, nxt, cache)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_family_greedy_tokens_match_reference(arch):
    jc, tc, jp, tp, tokens, pre = _family(arch)
    japi, tapi = j_model(jc), t_model(tc)
    if tapi.decode_loop is not None:
        tok_j = np.asarray(japi.decode_loop(jc, jp, jnp.asarray(tokens), 6,
                                            **_kw(pre, False)))
        tok_t = tapi.decode_loop(tc, tp, _t(tokens), 6,
                                 **_kw(pre, True)).numpy()
    else:
        tok_j = _greedy(japi, jc, jp, jnp.asarray(tokens), 6, pre, False)
        tok_t = _greedy(tapi, tc, tp, _t(tokens), 6, pre, True)
    np.testing.assert_array_equal(tok_t, tok_j)


# ---------------------------------------------------------------------------
# analog serving of the rwkv, MoE and vlm families
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _analog_case(arch):
    """The reference's Design-A pack programmed and calibrated on the
    smoke config, carried into the port, with the inputs of the tests."""
    jc, tc, jp, tp, _, _ = _family(arch)
    rng = np.random.default_rng(3)
    calib = rng.integers(0, jc.vocab, size=(4, 16)).astype(np.int32)
    prompts = rng.integers(0, jc.vocab, size=(3, 7)).astype(np.int32)
    pre = None
    if jc.frontend:
        pre = (rng.standard_normal((4, jc.n_frontend_tokens, jc.d_model))
               * 0.02).astype(np.float32)
    j_spec = JA.design_a(error=JE.state_proportional(0.05), fused="oracle")
    t_spec = TA.design_a(error=TE.state_proportional(0.05), fused="oracle")
    j_pack = JAE.program_lm(jc, jp, j_spec, jax.random.PRNGKey(7))
    j_pack = jax.jit(lambda p, pk, c: JAE.calibrate_lm(
        jc, p, pk, c, **_kw(pre, False)))(jp, j_pack, jnp.asarray(calib))
    t_pack = interop.pack_from_numpy(_export_pack(j_pack), t_spec, tc,
                                     device="cpu")
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, calib=calib, prompts=prompts,
                pre=pre, j_pack=j_pack, t_pack=t_pack)


@pytest.fixture(scope="module", params=ANALOG_ARCHS)
def analog(request):
    return _analog_case(request.param)


def test_analog_program_codes_equal_reference(analog):
    a = analog
    jc = JAE.lm_program_codes(a["jc"], a["jp"], JA.design_a())
    tc = TAE.lm_program_codes(a["tc"], a["tp"], TA.design_a())
    assert sorted(jc) == sorted(tc)
    assert TAE.lm_hook_names(a["tc"]) == JAE.lm_hook_names(a["jc"])
    assert set(tc) - {"head"} <= set(TAE.lm_hook_names(a["tc"]))
    assert sorted(a["t_pack"].layer_weights) == sorted(
        a["j_pack"].layer_weights)
    for name in jc:
        for field in ("c_pos", "c_neg", "c_unit"):
            want = getattr(jc[name].codes, field)
            got = getattr(tc[name].codes, field)
            assert (got is None) == (want is None), (name, field)
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(tc[name].w_scale.numpy(),
                                      np.asarray(jc[name].w_scale))


def test_analog_calibration_matches_reference_ranges(analog):
    a = analog
    kw = {} if a["pre"] is None else {"prefix_embeds": _t(a["pre"])}
    recal = TAE.calibrate_lm(a["tc"], a["tp"], a["t_pack"], _t(a["calib"]),
                             **kw)
    j_pack = a["j_pack"]
    for name in j_pack.layer_lo:
        for field in ("layer_lo", "layer_hi", "layer_act"):
            np.testing.assert_allclose(
                getattr(recal, field)[name].numpy(),
                np.asarray(getattr(j_pack, field)[name]), rtol=1e-5,
                err_msg=f"{field}[{name}]")
    for field in ("head_lo", "head_hi", "head_act"):
        np.testing.assert_allclose(getattr(recal, field).numpy(),
                                   np.asarray(getattr(j_pack, field)),
                                   rtol=1e-5, err_msg=field)


@functools.lru_cache(maxsize=None)
def _reference_oracle(kw_items):
    """The reference's fused oracle, jitted once per keyword set."""
    from repro.kernels import ops as j_ops

    kw = dict(kw_items)
    return jax.jit(lambda x, gp, gm, lo, hi, sc: j_ops.fused_mvm(
        x, gp, gm, adc_lo=lo, adc_hi=hi, scale=sc, backend="oracle", **kw))


@jax.jit
def _reference_pre_adc(x_parts, g_pos, g_neg):
    """The reference oracle's own pre-ADC values (P, S, 1, M, N) of analog
    accumulation: each dot over the oracle's operand tiles
    (``repro.kernels.ops.fused_mvm``'s ``bm``/``bn``), as it takes them."""
    from repro.kernels import ops as j_ops

    m, p, _ = x_parts.shape
    n_slices, _, _, n = g_pos.shape
    bm, bn = j_ops._pick_tile(m, 128), j_ops._pick_tile(n, 128, lane=True)
    x = j_ops._pad_to(x_parts, 0, bm)
    gp, gm = j_ops._pad_to(g_pos, 3, bn), j_ops._pad_to(g_neg, 3, bn)
    out = []
    for pi in range(p):
        per_slice = []
        for s in range(n_slices):
            tiles = [[jnp.dot(x[i:i + bm, pi, :],
                              gp[s, pi, :, j:j + bn] - gm[s, pi, :, j:j + bn],
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST)
                      for j in range(0, gp.shape[3], bn)]
                     for i in range(0, x.shape[0], bm)]
            per_slice.append(jnp.block(tiles)[:m, :n])
        out.append(jnp.stack(per_slice))
    return jnp.stack(out)[:, :, None]


class _PortTrace:
    """The port's analog run, call by call: each input quantizer's integer
    codes, and each fused site held to the fused bound against the
    reference's oracle on the same operands, a one-code ADC flip allowed
    where a pre-ADC value lies within 4 ulps of a rounding edge or the two
    packages' own pre-ADC values lie on either side of it (the flipped
    rows are noted), and each MoE router's top-k experts with its gates.
    ``step`` counts the head's calls."""

    def __init__(self, monkeypatch, vocab: int):
        from repro_torch.core import analog as t_analog
        from repro_torch.kernels import ref as t_ref

        self.vocab, self.step, self.calls = vocab, 0, []
        self._plain = t_ref.fused_mvm_diff
        self._quantize = t_analog.quantize_acts
        self._route = TMLP._route
        monkeypatch.setattr(t_ref, "fused_mvm_diff", self._fused)
        monkeypatch.setattr(t_analog, "quantize_acts", self._quantize_acts)
        monkeypatch.setattr(TMLP, "_route", self._routing)

    def _routing(self, xt, router, k):
        gates, topw, topi = self._route(xt, router, k)
        self.calls.append(("route", self.step,
                           (torch.sort(topi, dim=-1).values.numpy(),
                            gates.numpy())))
        return gates, topw, topi

    def _quantize_acts(self, x, *args, **kw):
        q = self._quantize(x, *args, **kw)
        self.calls.append(("q", self.step,
                           q.values.reshape(-1, x.shape[-1]).numpy()))
        return q

    def _fused(self, x_parts, g_pos, g_neg, adc_lo, adc_hi, scale, **kw):
        from repro_torch.kernels import tolerance
        from repro_torch.kernels.fused import adc_lsb
        from repro_torch.kernels.ref import fused_pre_adc

        assert kw["n_bits"] is None   # Design A: analog accumulation
        y = self._plain(x_parts, g_pos, g_neg, adc_lo, adc_hi, scale, **kw)
        args = [jnp.asarray(t.numpy()) for t in
                (x_parts, g_pos, g_neg, adc_lo, adc_hi, scale)]
        y_ref = torch.as_tensor(np.array(
            _reference_oracle(tuple(sorted(kw.items())))(*args)))
        v_ref = torch.as_tensor(np.array(_reference_pre_adc(*args[:3])))
        sc = float(torch.as_tensor(scale).reshape(()))
        n_slices = g_pos.shape[0]
        lo, hi = tolerance._slice_ranges(adc_lo, adc_hi, n_slices, "cpu")

        def terms():
            v_all = fused_pre_adc(x_parts, g_pos, g_neg, None)
            for pi in range(x_parts.shape[1]):
                for s in range(n_slices):
                    lsb = adc_lsb(lo[s], hi[s], kw["adc_bits"])
                    step = sc * float(lsb) * 2.0 ** (kw["cell_bits"] * s)
                    yield v_all[pi, s, 0], lo[s], lsb, step, v_ref[pi, s, 0]

        r = tolerance._codes_check(y_ref, y, tolerance.FUSED_CODES * sc,
                                   terms)
        assert r["ok"], r
        d = (y - y_ref).abs()
        tight = (d <= 2 * tolerance._spacing(torch.maximum(
            y.abs(), y_ref.abs()))) | (d <= tolerance.FUSED_CODES * sc)
        self.calls.append(("adc", self.step, (y.numpy(), sc * float(
            adc_lsb(lo[0], hi[0], kw["adc_bits"])) if n_slices == 1
            else None)))
        if g_pos.shape[-1] == self.vocab:
            self.step += 1
        return y


@contextlib.contextmanager
def _reference_calls():
    """List, in call order, every input quantizer's integer codes and every
    fused site's output of the reference's run (read out of its compiled
    layer scan by ordered host callbacks)."""
    from repro.core import analog as j_analog
    from repro.kernels import ops as j_ops

    calls = {"q": [], "adc": [], "route": []}
    quantize, fused = j_analog.quantize_acts, j_ops.fused_mvm
    top_k = jax.lax.top_k

    def note(kind):
        return lambda v: calls[kind].append(np.array(v))

    def quantize_recording(x, *args, **kw):
        q = quantize(x, *args, **kw)
        jax.debug.callback(note("q"), q.values.reshape(-1, x.shape[-1]),
                           ordered=True)
        return q

    def fused_recording(*args, **kw):
        y = fused(*args, **kw)
        jax.debug.callback(note("adc"), y, ordered=True)
        return y

    def top_k_recording(x, k):
        w, i = top_k(x, k)
        jax.debug.callback(note("route"), jnp.sort(i, axis=-1), ordered=True)
        return w, i

    j_analog.quantize_acts, j_ops.fused_mvm = quantize_recording, \
        fused_recording
    jax.lax.top_k = top_k_recording       # the MoE router's choice
    try:
        yield calls
        jax.effects_barrier()
    finally:
        j_analog.quantize_acts, j_ops.fused_mvm = quantize, fused
        jax.lax.top_k = top_k


def _taint(trace: _PortTrace, ref, batch: int, s0: int, stop=None):
    """Each batch row's first position downstream of a rounding departure
    between the packages (absent where none).  A departure, in a row not
    yet departed, is an input code that differs from the reference's by
    one (a value at a quantizer's rounding edge), a site output that
    differs from the reference's on the same codes by at most one ADC code
    per element, or an MoE router's choice of experts where its k-th and
    next gates lie within 1e-3 of each other (a routing near tie); any
    larger difference fails.  Positions: prefill
    0..s0-1 (its head call reads position s0-1), decode step j at s0-1+j; ``stop[b]`` ends row b's checks
    there (where its tokens already differ)."""
    from repro_torch.kernels import tolerance

    n = {k: sum(1 for c in trace.calls if c[0] == k) for k in ref}
    assert n == {k: len(v) for k, v in ref.items()}, n
    first: dict = {}
    seen = {k: 0 for k in ref}
    for kind, step, data in trace.calls:
        theirs = ref[kind][seen[kind]]
        seen[kind] += 1
        if kind == "q":
            ours = data
            rows = np.nonzero((ours != theirs).any(axis=1))[0]
        elif kind == "route":
            ours, gates = data
            rows = np.nonzero((ours != theirs).any(axis=1))[0]
        else:
            ours, code = data
            d = np.abs(ours - theirs)
            tight = (d <= 2 * np.spacing(np.maximum(np.abs(ours), np.abs(
                theirs)))) | (d <= tolerance.FUSED_CODES * code)
            rows = np.nonzero(~tight.all(axis=1))[0]
        m = ours.shape[0]
        per = m // batch
        for r in rows:
            b, t = divmod(int(r), per)
            # a row's one position per call (decode, or the prefill's
            # head on the last token), else the prefill's position t
            pos = s0 - 1 + step if per == 1 else t
            if b in first and first[b] <= pos:
                continue
            if stop is not None and pos >= stop.get(b, 1 << 30):
                continue
            gap = np.abs(ours[r] - theirs[r]).max()
            if kind == "q":
                assert gap == 1, (f"row {b} position {pos}: an input code "
                                  f"{gap} away from the reference's")
            elif kind == "route":
                g = np.sort(gates[r])[::-1]
                k = ours.shape[1]
                assert g[k - 1] - g[k] <= 1e-3 * g[k - 1], (
                    f"row {b} position {pos}: experts {ours[r]} against the "
                    f"reference's {theirs[r]} away from a routing near tie")
            else:
                assert gap <= code * (1 + 1e-3), (
                    f"row {b} position {pos}: a site output {gap / code:.3f} "
                    f"ADC codes away from the reference's on the same codes")
            first[b] = pos
    return first


def test_analog_logits_on_reference_pack_within_bound(analog, monkeypatch):
    """``tests/test_torch_model.py``'s bound: 2 ulp or 0.25 of the head's
    dequant step, except at and after a position where the two packages
    first part by one code at a rounding edge (``_taint``), the reference
    run eagerly so that its codes can be read."""
    a = analog
    calib = a["calib"]
    with _reference_calls() as ref:
        lg_j = np.asarray(JT.forward(a["jc"], a["jp"], jnp.asarray(calib),
                                     pack=a["j_pack"], remat=False,
                                     **_kw(a["pre"], False))[0])
    trace = _PortTrace(monkeypatch, a["tc"].vocab)
    lg_t = TT.forward(a["tc"], a["tp"], _t(calib), pack=a["t_pack"],
                      **_kw(a["pre"], True))[0].numpy()
    first = _taint(trace, ref, calib.shape[0], calib.shape[1])
    d = np.abs(lg_t - lg_j)
    mag = np.maximum(np.abs(lg_t), np.abs(lg_j))
    ok = (d <= 2 * np.spacing(mag.astype(np.float32))) \
        | (d <= 0.25 * _head_grid(a["t_pack"]))
    for b, t in first.items():
        ok[b, t:] = True
    assert ok.all(), (f"{int((~ok).sum())} of {ok.size} logits outside the "
                      f"bound, max diff {d[~ok].max():.3e}; rows part at "
                      f"{first}")


def test_analog_decode_tokens_match_up_to_near_ties(analog, monkeypatch):
    """``decode_lm``'s tokens equal the reference's, or a row first leaves
    them at a near tie (top-2 logit gap under 1e-4 of the logit scale), or
    at or after a step where the packages parted by one code at a rounding
    edge (``_taint``)."""
    a = analog
    prompts = a["prompts"]
    b, s0 = prompts.shape
    with _reference_calls() as ref:
        tok_j = np.asarray(JAE.decode_lm(a["jc"], a["jp"],
                                         jnp.asarray(prompts), 8,
                                         pack=a["j_pack"]))
    trace = _PortTrace(monkeypatch, a["tc"].vocab)
    tok_t = TAE.decode_lm(a["tc"], a["tp"], _t(prompts), 8,
                          pack=a["t_pack"]).numpy()
    assert trace.step == 8
    split = {row: int(np.nonzero(tok_t[row] != tok_j[row])[0][0])
             for row in range(b) if (tok_t[row] != tok_j[row]).any()}
    first = _taint(trace, ref, b, s0,
                   stop={row: s0 + i for row, i in split.items()})
    for row, i in split.items():
        if first.get(row, 1 << 30) <= s0 - 1 + i:
            continue
        seq = np.concatenate([prompts[row], tok_j[row, :i]])[None]
        lg = np.asarray(JT.forward(a["jc"], a["jp"], jnp.asarray(seq),
                                   pack=a["j_pack"], remat=False)[0])[0, -1]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < 1e-4 * np.abs(lg).max(), (
            f"row {row} leaves the reference at step {i} away from a near "
            f"tie and from any rounding departure ({first})")


# ---------------------------------------------------------------------------
# the families' raises, in both packages
# ---------------------------------------------------------------------------


def _serve_pkg(is_torch):
    if is_torch:
        import repro_torch.serve as m
    else:
        import repro.serve as m
    return m


def _on(arch, fn):
    def make(side):
        cfg, params, api = side(arch)
        return lambda: fn(cfg, params, api, side.is_torch)
    return make


def _program(cfg, params, api, is_torch, spec=None):
    eng = TAE if is_torch else JAE
    a = TA if is_torch else JA
    spec = spec if spec is not None else a.design_a()
    key = 0 if is_torch else jax.random.PRNGKey(0)
    return eng.program_lm(cfg, params, spec, key)


def _program_all_digital(cfg, params, api, is_torch):
    if is_torch:
        from repro_torch.hw import Profile, Rule
    else:
        from repro.hw import Profile, Rule
    a = TA if is_torch else JA
    return _program(cfg, params, api, is_torch,
                    spec=Profile(rules=(Rule("attn.*", a.design_a()),)))


def _decode_lm(cfg, params, api, is_torch):
    eng = TAE if is_torch else JAE
    tok = np.zeros((1, 4), np.int32)
    return eng.decode_lm(cfg, params, _t(tok) if is_torch
                         else jnp.asarray(tok), 2)


RAISES = {
    "decode_step_flash_rwkv": (
        _on("rwkv6-3b", lambda c, p, api, t: api.decode_step(
            c, p, _t(np.zeros((1, 1), np.int32)) if t
            else jnp.zeros((1, 1), jnp.int32),
            api.init_cache(c, 1, 8, **({"device": "cpu"} if t else {})),
            attn_backend="flash")),
        "rwkv has no KV cache"),
    "prefill_ragged_rwkv": (
        _on("rwkv6-3b", lambda c, p, api, t: api.prefill_ragged(
            c, p, _t(np.zeros((1, 4), np.int32)) if t
            else jnp.zeros((1, 4), jnp.int32), true_lens=[4])),
        "prefill_ragged does not support the rwkv family"),
    "init_page_pool_rwkv": (
        _on("rwkv6-3b", lambda c, p, api, t: api.init_page_pool(
            c, 4, 8, **({"device": "cpu"} if t else {}))),
        r"rwkv state is O\(1\) per slot"),
    "prefill_cached_rwkv": (
        _on("rwkv6-3b", lambda c, p, api, t: api.prefill_cached(
            c, p, np.zeros((1, 4), np.int32), true_lens=[4], ctx_lens=[0],
            ctx_cache={})),
        "prefill_cached does not support the rwkv family"),
    "runtime_rwkv": (
        _on("rwkv6-3b", lambda c, p, api, t: _serve_pkg(t).ServeRuntime(c, p)),
        "continuous batching does not support the rwkv family"),
    "runtime_moe": (
        _on("qwen3-moe-235b-a22b",
            lambda c, p, api, t: _serve_pkg(t).ServeRuntime(c, p)),
        "continuous batching does not support MoE configs"),
    "runtime_hybrid": (
        _on("zamba2-7b", lambda c, p, api, t: _serve_pkg(t).ServeRuntime(c, p)),
        "has no continuous-batching support"),
    "paged_runtime_rwkv": (
        _on("rwkv6-3b",
            lambda c, p, api, t: _serve_pkg(t).PagedServeRuntime(c, p)),
        "continuous batching does not support the rwkv family"),
    "paged_runtime_hybrid": (
        _on("zamba2-7b",
            lambda c, p, api, t: _serve_pkg(t).PagedServeRuntime(c, p)),
        "has no paged-KV support"),
    "program_encdec": (_on("whisper-large-v3", _program),
                       "has no 'layers' parameter stack"),
    "program_hybrid": (_on("zamba2-7b", _program),
                       "no analog hooks found for family 'hybrid'"),
    "program_all_digital": (_on("rwkv6-3b", _program_all_digital),
                            "resolves every projection hook"),
    "decode_lm_hybrid": (_on("zamba2-7b", _decode_lm),
                         "has no batched decode loop"),
    "decode_lm_audio": (_on("whisper-large-v3", _decode_lm),
                        "has no batched decode loop"),
}


class _Side:
    def __init__(self, is_torch):
        self.is_torch = is_torch

    def __call__(self, arch):
        jc, tc, jp, tp, _, _ = _family(arch)
        if self.is_torch:
            return tc, tp, t_model(tc)
        return jc, jp, j_model(jc)


@pytest.mark.parametrize("case", sorted(RAISES))
def test_family_raises_as_reference(case):
    make, match = RAISES[case]
    for is_torch in (False, True):
        with pytest.raises(ValueError, match=match):
            make(_Side(is_torch))()
