"""Drift, stuck-cell faults and self-healing serving in the port
(``repro_torch.core.errors``, ``core.analog.age_conductances``,
``serve.analog_engine.age_pack``, ``serve.health``, the runtime's
``manager=``/``clock=``/``heal=``, ``runtime.fault``) against the JAX
package, on the CPU, at the smoke config (``qwen1.5-4b``, 2 layers, d 64).

``torch.Generator`` cannot replay ``jax.random``, so the random stages are
held by statistics, each bound stated where it is checked:

* drift: per-cell exponents taken back out of ``g_t / g``; the mean of
  their log within 0.012 of the reference's (5 sigma of the difference of
  two means of 32768 draws at sigma_nu 0.3) and their spread within 0.01
  of sigma_nu;
* faults: the stuck share within 0.014 (5 sigma) of ``1 - exp(-rate (t -
  1))`` and of the reference's share, the high share among stuck cells
  within 0.02 (5 sigma) of ``p_hi``.

The port's own contracts are the reference's (``tests/test_drift.py``):
equal tensors where the reference pins bit identity.  Stages downstream of
the draws run on the reference's own aged and healed conductances,
exported to numpy: served tokens equal the reference's ``decode_lm`` but at
a near tie of its logits (top-2 gap under 1e-4 of the logit scale),
recalibrated ranges within the calibration bound of
``tests/test_torch_model.py`` (rtol 1e-5), the health probe within rtol
1e-4.  The heal scheduler records the reference's events on the same trace
and policy.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import analog as JA
from repro.core import errors as JE
from repro.data.synthetic import SyntheticLM
from repro.hw import Profile as JProfile
from repro.models import transformer as JT
from repro.serve import PackManager as JPackManager
from repro.serve import ServeRuntime as JServeRuntime
from repro.serve import DriftClock as JDriftClock
from repro.serve import HealPolicy as JHealPolicy
from repro.serve import decode_lm as j_decode
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import analog as A
from repro_torch.core import errors as E
from repro_torch.hw import DIGITAL, Profile
from repro_torch.models import transformer as T
from repro_torch.runtime.fault import (Heartbeat, StepFailed,
                                       StragglerMonitor, is_transient,
                                       resilient_step)
from repro_torch.serve import (DriftClock, HealPolicy, PackManager,
                               PagedServeRuntime, ServeRuntime, age_pack,
                               calibrate_lm, decode_lm, program_lm)
from test_torch_model import _export_pack, _np_tree

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
NPZ = os.path.join(ROOT, "benchmarks", "_cache", "lm_qwen1_5-4b_0.npz")
SEED = 5

#: tests/test_drift.py's AGING_SPEC: every site of the pack ages
J_AGING_SPEC = JA.design_a(error=JE.state_independent(0.05),
                           drift=JE.power_law_drift(0.2, sigma_nu=0.3),
                           fault=JE.stuck_faults(1e-3))
AGING_SPEC = A.design_a(error=E.state_independent(0.05),
                        drift=E.power_law_drift(0.2, sigma_nu=0.3),
                        fault=E.stuck_faults(1e-3), fused="kernel")
#: aging on but inert (nu = 0, no programming error): every rewrite
#: reproduces the same conductances
NOOP_SPEC = A.design_a(error=E.none(), drift=E.power_law_drift(0.0))
J_NOOP_SPEC = JA.design_a(error=JE.none(), drift=JE.power_law_drift(0.0))
FORCE_HEAL = dict(check_every=1, loss_mult=0.0, loss_add=-1.0)


def _calib():
    return np.asarray(SyntheticLM(cfg=j_smoke("qwen1.5-4b"), seq_len=16,
                                  global_batch=4, seed=0).batch(1)["tokens"])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke model's ops are tiny, so one intra-op thread runs them
    fastest, and several pytest-xdist workers sharing the cores do not
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    cfg = get_smoke_config("qwen1.5-4b")
    params = T.init_params(cfg, 0, device="cpu")
    return cfg, params, _calib()


@pytest.fixture(scope="module")
def manager(lm):
    cfg, params, calib = lm
    return PackManager(cfg, params, AGING_SPEC, SEED, calib_tokens=calib)


def _tensors(pack):
    """Every tensor of a pack, in a fixed order."""
    out = []
    for name in sorted(pack.layer_weights):
        aw = pack.layer_weights[name]
        out += [aw.g_pos, aw.g_neg, aw.g_unit, aw.w_scale]
    for d in (pack.layer_lo, pack.layer_hi, pack.layer_act):
        out += [d[n] for n in sorted(d)]
    if pack.head is not None:
        h = pack.head
        out += [h.g_pos, h.g_neg, h.g_unit, h.w_scale]
    out += [pack.head_lo, pack.head_hi, pack.head_act]
    return out


def _equal(a, b) -> bool:
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    return all((x is None and y is None) or
               (x is not None and y is not None and torch.equal(x, y))
               for x, y in zip(ta, tb))


def _heal_all(m, t_now):
    for target in m.heal_targets():
        if target == "head":
            m.reprogram_head(t_now=t_now)
        else:
            m.reprogram_band(target, t_now=t_now)


# ---------------------------------------------------------------------------
# the draws: statistics against the formulas and the reference
# ---------------------------------------------------------------------------


def _g(shape=(64, 512), seed=0):
    """Conductances uniform in (0.1, 1]."""
    rng = np.random.default_rng(seed)
    return (1.0 - 0.9 * rng.random(shape)).astype(np.float32)


def test_drift_statistics_match_reference():
    g = _g()
    t, nu, sig = 64.0, 0.2, 0.3
    port = E.power_law_drift(nu, sigma_nu=sig).apply(torch.as_tensor(g), t,
                                                     seed=3).numpy()
    ref = np.asarray(JE.power_law_drift(nu, sigma_nu=sig).apply(
        jnp.asarray(g), t, jax.random.PRNGKey(3)))
    assert (port <= g).all() and (ref <= g).all()     # aging never raises g
    log_nu = {k: np.log(-np.log(v.astype(np.float64) / g) / np.log(t))
              for k, v in (("port", port), ("ref", ref))}
    # mean of log(nu_cell): log(nu); within 0.012 of the reference's
    # (5 sigma of the difference of two means of 32768 draws)
    assert abs(log_nu["port"].mean() - log_nu["ref"].mean()) < 0.012
    assert abs(log_nu["port"].mean() - np.log(nu)) < 0.012
    assert abs(log_nu["port"].std() - sig) < 0.01
    # the fresh age is the identity, and a seed replays
    dm = E.power_law_drift(nu, sigma_nu=sig)
    assert torch.equal(dm.apply(torch.as_tensor(g), 1.0, seed=3),
                       torch.as_tensor(g))
    assert np.array_equal(dm.apply(torch.as_tensor(g), t, seed=3).numpy(),
                          port)
    assert not np.array_equal(dm.apply(torch.as_tensor(g), t,
                                       seed=4).numpy(), port)


def test_fault_statistics_match_reference():
    g = _g(seed=1)
    rate, t, p_hi = 1e-2, 64.0, 0.5
    g_lo = A.design_a().mapping.g_min
    fm = E.stuck_faults(rate, p_hi=p_hi)
    port = fm.apply(torch.as_tensor(g), t, seed=7, g_lo=g_lo).numpy()
    ref = np.asarray(JE.stuck_faults(rate, p_hi=p_hi).apply(
        jnp.asarray(g), t, jax.random.PRNGKey(7), g_lo=g_lo))
    want = 1.0 - np.exp(-rate * (t - 1.0))
    stuck = port != g
    # a stuck cell reads exactly g_min or 1.0; every other cell is unchanged
    assert np.isin(port[stuck], np.float32([g_lo, 1.0])).all()
    # stuck share within 0.014 (5 sigma) of the formula and the reference's
    assert abs(stuck.mean() - want) < 0.014
    assert abs(stuck.mean() - (ref != g).mean()) < 0.014
    # high share among stuck cells within 0.02 (5 sigma) of p_hi
    assert abs((port[stuck] == 1.0).mean() - p_hi) < 0.02
    # the stuck set grows with t, a stuck cell keeps its value, and t = 1
    # is the identity
    early = fm.apply(torch.as_tensor(g), 16.0, seed=7, g_lo=g_lo).numpy()
    s16 = early != g
    assert 0 < s16.sum() < stuck.sum() and not (s16 & ~stuck).any()
    assert np.array_equal(early[s16], port[s16])
    assert torch.equal(fm.apply(torch.as_tensor(g), 1.0, seed=7, g_lo=g_lo),
                       torch.as_tensor(g))
    assert float(fm.stuck_prob(1.0)) == 0.0


def test_age_conductances_and_program_time_aging():
    """Aging at program time is ``age_conductances`` on the programmed
    (noisy) stacks under ``fold_seed(seed, _AGE_FOLD)``: the noise draws do
    not change, and the fresh age changes nothing."""
    w = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (1500, 24)).astype(np.float32) * 0.1)        # 2 partitions, padded
    base = A.design_a(error=E.state_proportional(0.05))
    fresh = A.program(w, base, seed=11)
    aging = dataclasses.replace(base, drift=E.power_law_drift(0.2, 0.3),
                                fault=E.stuck_faults(1e-2))
    at1 = A.program(w, aging, seed=11)
    assert torch.equal(at1.g_pos, fresh.g_pos)
    assert torch.equal(at1.g_neg, fresh.g_neg)
    old = dataclasses.replace(
        aging, drift=dataclasses.replace(aging.drift, t=64.0),
        fault=dataclasses.replace(aging.fault, t=64.0))
    aged = A.program(w, old, seed=11)
    want = A.age_conductances(fresh.g_pos, fresh.g_neg, fresh.g_unit, aging,
                              E.fold_seed(11, A._AGE_FOLD), t_drift=64.0,
                              t_fault=64.0)
    assert torch.equal(aged.g_pos, want[0])
    assert torch.equal(aged.g_neg, want[1])
    assert not torch.equal(aged.g_pos, fresh.g_pos)
    # the padded rows of the last partition age too (shapes as the
    # reference's)
    assert aged.g_pos.shape == fresh.g_pos.shape


def test_profile_selectors_match_reference():
    spec = A.design_a()
    port = Profile.by_class(attn=spec, mlp=DIGITAL, head=spec, default=spec)
    ref = JProfile.by_class(attn=JA.design_a(), mlp="digital",
                            head=JA.design_a(), default=JA.design_a())
    assert [k for k, _ in port.selectors()] == \
        [k for k, _ in ref.selectors()] == ["attn", "head", "default"]
    assert [k for k, _ in Profile(default=DIGITAL).selectors()] == []


# ---------------------------------------------------------------------------
# the port's own aging and healing contracts (tests/test_drift.py)
# ---------------------------------------------------------------------------


def test_manager_fresh_pack_matches_program_calibrate(lm, manager):
    cfg, params, calib = lm
    ref = calibrate_lm(cfg, params, program_lm(cfg, params, AGING_SPEC,
                                               SEED), torch.as_tensor(calib))
    assert _equal(manager.fresh_pack, ref)


def test_aged_at_t0_is_noop(manager):
    assert _equal(manager.aged(1.0), manager.fresh_pack)


def test_aging_replays_and_responds_to_seed(manager):
    a1, a2 = manager.aged(64.0), manager.aged(64.0)
    assert _equal(a1, a2)
    assert not _equal(a1, manager.fresh_pack)
    other = age_pack(manager.fresh_pack, 64.0, manager.age_seed + 1)
    assert not _equal(a1, other)


def test_pack_age_method(lm, manager):
    cfg, params, calib = lm
    pack = manager.fresh_pack
    assert _equal(pack.age(64.0, 1), pack.age(64.0, 1))
    assert _equal(pack.age(1.0, 1), pack)
    assert not _equal(pack.age(64.0, 1), pack.age(64.0, 2))
    still = calibrate_lm(cfg, params, program_lm(
        cfg, params, A.design_a(error=E.state_independent(0.05)), SEED),
        torch.as_tensor(calib))
    assert still.age(64.0, 1) is still             # every model off


def test_band_reprogram_at_epoch_zero_equals_fresh_program(manager):
    fresh = manager.fresh_pack
    assert manager.epoch_seed(0) == SEED
    for b, (lo, hi) in enumerate(fresh.bands):
        weights = manager.program_band(b, manager.epoch_seed(0))
        for name, aw in weights.items():
            ref = fresh.layer_weights[name]
            for field in ("g_pos", "g_neg", "w_scale"):
                assert torch.equal(getattr(aw, field),
                                   getattr(ref, field)[lo:hi]), (b, name)


def test_reprogram_resets_drift_clock(lm):
    cfg, params, calib = lm
    spec = A.design_a(error=E.none(),
                      drift=E.power_law_drift(0.2, sigma_nu=0.3))
    m = PackManager(cfg, params, spec, SEED, calib_tokens=calib)
    fresh = [t.clone() for t in _tensors(m.fresh_pack) if t is not None]
    t = 64.0
    assert not _equal(m.aged(t), m.fresh_pack)
    _heal_all(m, t)
    assert _equal(m.aged(t), m.fresh_pack)
    assert not _equal(m.aged(4 * t), m.fresh_pack)
    # the splice left the as-built pack as it was
    assert all(torch.equal(a, b) for a, b in zip(
        fresh, [x for x in _tensors(m.fresh_pack) if x is not None]))


def test_faults_survive_reprogramming(lm):
    cfg, params, calib = lm
    spec = A.design_a(error=E.none(), fault=E.stuck_faults(1e-2))
    m = PackManager(cfg, params, spec, SEED, calib_tokens=calib)
    t = 64.0
    before = m.aged(t)
    assert not _equal(before, m.fresh_pack)
    _heal_all(m, t)
    assert m.band_epochs == [1]
    assert _equal(m.aged(t), before)


def test_manager_rejects_pre_aged_specs(lm):
    cfg, params, calib = lm
    spec = dataclasses.replace(
        AGING_SPEC, drift=dataclasses.replace(AGING_SPEC.drift, t=64.0))
    with pytest.raises(ValueError, match="fresh age"):
        PackManager(cfg, params, spec, SEED, calib_tokens=calib)
    prof = Profile.by_class(attn=AGING_SPEC, default=dataclasses.replace(
        AGING_SPEC, fault=dataclasses.replace(AGING_SPEC.fault, t=2.0)))
    with pytest.raises(ValueError, match="fresh age"):
        PackManager(cfg, params, prof, SEED, calib_tokens=calib)


# ---------------------------------------------------------------------------
# downstream of the draws, on the reference's own conductances
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """The committed trained smoke LM in both packages."""
    cfg = get_smoke_config("qwen1.5-4b")
    j_cfg = j_smoke("qwen1.5-4b")
    j_params = jax.tree.map(jnp.asarray, _np_tree(NPZ))
    params = interop.load_params_npz(NPZ, device="cpu")
    return cfg, params, j_cfg, j_params, _calib()


@pytest.fixture(scope="module")
def ref_healed(trained):
    """The reference's manager under tests/test_drift.py's AGING_SPEC,
    every band reprogrammed at t = 16, then ``recalibrate(aged(64))``;
    with the aged pack before recalibration."""
    _, _, j_cfg, j_params, calib = trained
    m = JPackManager(j_cfg, j_params, J_AGING_SPEC, jax.random.PRNGKey(SEED),
                     calib_tokens=jnp.asarray(calib))
    fresh = m.fresh_pack
    _heal_all(m, 16.0)
    aged = m.aged(64.0)
    return m, fresh, aged, m.recalibrate(aged)


def _port(cfg, j_pack):
    return interop.pack_from_numpy(_export_pack(j_pack), AGING_SPEC, cfg,
                                   device="cpu")


def _ref_near_tie(j_cfg, j_params, j_pack, prompt, ref, got) -> bool:
    diff = np.nonzero(ref != got)[0]
    if diff.size == 0:
        return True
    seq = np.concatenate([prompt, ref[:diff[0]]])[None]
    lg = np.asarray(JT.forward(j_cfg, j_params, jnp.asarray(seq),
                               pack=j_pack, remat=False)[0])[0, -1]
    top2 = np.sort(lg)[-2:]
    return top2[1] - top2[0] < 1e-4 * np.abs(lg).max()


def test_runtime_on_reference_healed_pack_matches_reference_decode(
        trained, ref_healed):
    """The port's ``ServeRuntime`` on the reference's aged-then-healed pack
    against the reference's ``decode_lm`` on the same pack: equal tokens
    but at a near tie of the reference's logits."""
    cfg, params, j_cfg, j_params, _ = trained
    healed = ref_healed[3]
    pack = _port(cfg, healed)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, size=int(rng.integers(4, 6)))
             .astype(np.int32), int(rng.integers(4, 6))) for _ in range(5)]
    rt = ServeRuntime(cfg, params, pack=pack, max_slots=2, max_len=24)
    uids = [rt.submit(p, max_new_tokens=n) for p, n in reqs]
    outs = rt.run()
    same = 0
    for (p, n), uid in zip(reqs, uids):
        ref = np.asarray(j_decode(j_cfg, j_params, jnp.asarray(p)[None], n,
                                  pack=healed))[0]
        got = outs[uid]
        assert got.shape == ref.shape
        assert _ref_near_tie(j_cfg, j_params, healed, p, ref, got)
        same += int(np.array_equal(got, ref))
    assert same >= 1


#: one step of calibrate_act_range's geometric candidate grid
CLIP_STEP = 2.0 ** (6 / 31)


def _clip_l1(x: torch.Tensor, hi: float, bits: int) -> float:
    """calibrate_act_range's objective for the clip ``hi`` on samples
    ``x``, summed in float64."""
    from repro_torch.core.quant import quantize_acts

    flat = x.reshape(-1).float()
    absmax = flat.abs().max()
    snap = torch.round(torch.tensor(hi) / absmax * 4096) / 4096 * absmax
    q = quantize_acts(flat, bits, clip_hi=snap)
    return float((q.dequant().double() - flat.double()).abs().sum())


def test_port_recalibration_matches_reference_on_aged_pack(
        trained, ref_healed, monkeypatch):
    """``calibrate_lm`` on the reference's aged, uncalibrated conductances
    against the reference's ``recalibrate``.

    * Activation clips (phase 1): within rtol 1e-5 of the reference's, or
      one step of the candidate grid away where the two candidates' L1
      objectives, summed in float64 on the port's own samples, lie within
      1e-3 of each other.  The clip is an argmin over a grid; its samples
      pass through the activation quantizer of every site upstream, and an
      input within an ulp of a quantizer edge rounds the other way in one
      package (the flips ROADMAP queue C allows for ADC codes), which moves
      a near-tied argmin.  At most two clips may move (wq, wk and wv, which
      share their input, counting as one).
    * ADC ranges (phase 2), with the reference's clips installed: within
      rtol 1e-5 (the bound of ``tests/test_torch_model.py``), every site,
      every layer and the head.

    The reference's ranges are its ``calibrate_lm`` compiled as one
    program, as ``tests/test_torch_model.py`` compiles it: the manager's
    eager ``recalibrate`` gives the same layer ranges, but takes the
    head's percentile index in the eager float32 form (ROADMAP queue C).
    """
    import repro_torch.models.layers as t_layers
    from repro_torch.core.analog import analog_matmul
    from repro_torch.models.registry import get_model

    from repro.serve import calibrate_lm as j_calibrate

    cfg, params, j_cfg, j_params, calib = trained
    _, _, aged, eager = ref_healed
    healed = jax.jit(lambda p, pk, c: j_calibrate(j_cfg, p, pk, c))(
        j_params, aged, jnp.asarray(calib))
    for field in ("layer_lo", "layer_hi", "layer_act"):
        for name, v in getattr(eager, field).items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(
                getattr(healed, field)[name]))
    tokens = torch.as_tensor(calib)
    seen = []
    clip = t_layers.calibrate_act_range

    def recording(x, bits, **kw):
        out = clip(x, bits, **kw)
        seen.append((x, bits, float(out[1])))
        return out

    monkeypatch.setattr(t_layers, "calibrate_act_range", recording)
    pack = _port(cfg, aged)
    recal = calibrate_lm(cfg, params, pack, tokens)
    monkeypatch.undo()
    moved = set()
    for name in healed.layer_act:
        got = recal.layer_act[name].numpy()
        want = np.asarray(healed.layer_act[name])
        for layer in np.nonzero(~np.isclose(got, want, rtol=1e-5,
                                            atol=0))[0]:
            g, w = float(got[layer]), float(want[layer])
            assert np.isclose(max(g, w) / min(g, w), CLIP_STEP, rtol=1e-4), \
                (name, layer, g, w)
            x, bits, _ = next(c for c in seen if c[2] == g)
            e_g, e_w = _clip_l1(x, g, bits), _clip_l1(x, w, bits)
            assert abs(e_g - e_w) < 1e-3 * e_g, (name, layer, e_g, e_w)
            moved.add(("qkv" if name in ("wq", "wk", "wv") else name,
                       int(layer)))
    assert len(moved) <= 2, moved
    # phase 2 on the reference's clips
    ref_act = {n: torch.as_tensor(np.asarray(v))
               for n, v in healed.layer_act.items()}
    _, aux = get_model(cfg).forward(
        cfg, params, tokens, pack=dataclasses.replace(
            pack, layer_lo={}, layer_hi={}, layer_act=ref_act,
            head_lo=None, head_hi=None, head_act=None, collect=True))
    for name in healed.layer_lo:
        stats = aux[f"adc/{name}"].numpy()
        for i, field in enumerate(("layer_lo", "layer_hi")):
            np.testing.assert_allclose(
                stats[..., i], np.asarray(getattr(healed, field)[name]),
                rtol=1e-5, err_msg=f"{field}[{name}]")
    x = aux["final_hidden"].reshape(-1, cfg.d_model)
    _, stats = analog_matmul(x, pack.head, pack.head_spec,
                             act_hi=torch.as_tensor(
                                 np.asarray(healed.head_act)), collect=True)
    np.testing.assert_allclose(stats[:, 0].numpy(),
                               np.asarray(healed.head_lo), rtol=1e-5)
    np.testing.assert_allclose(stats[:, 1].numpy(),
                               np.asarray(healed.head_hi), rtol=1e-5)


def test_probe_loss_on_reference_fresh_pack(trained, ref_healed):
    """The port's health probe on the reference's fresh pack: within rtol
    1e-4 of the reference's own reference loss."""
    cfg, params, _, _, calib = trained
    m_ref, fresh, _, _ = ref_healed
    m = PackManager(cfg, params, AGING_SPEC, SEED, calib_tokens=calib)
    loss = m.probe_loss(_port(cfg, fresh))
    np.testing.assert_allclose(loss, m_ref.ref_loss, rtol=1e-4)


# ---------------------------------------------------------------------------
# the heal scheduler
# ---------------------------------------------------------------------------


def _trace(cfg, n, seed=0, lens=(3, 15), new=(2, 9)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, size=int(rng.integers(*lens)))
             .astype(np.int32), int(rng.integers(*new))) for _ in range(n)]


def _noop_manager(lm):
    cfg, params, calib = lm
    return PackManager(cfg, params, NOOP_SPEC, SEED, calib_tokens=calib)


def _serve(rt, reqs):
    for i, (p, n) in enumerate(reqs):
        rt.submit(p, max_new_tokens=n, uid=i)
    return rt.run()


@pytest.fixture(scope="module")
def j_noop(lm):
    """The reference's inert-aging manager on the reference's random-init
    smoke LM, shared by the scheduler cases: with inert aging and a policy
    that heals on every probe, the schedule does not depend on the
    manager's reprogram epochs."""
    _, _, calib = lm
    j_cfg = j_smoke("qwen1.5-4b")
    j_params = JT.init_params(j_cfg, jax.random.PRNGKey(0))
    return j_cfg, j_params, JPackManager(
        j_cfg, j_params, J_NOOP_SPEC, jax.random.PRNGKey(SEED),
        calib_tokens=jnp.asarray(calib))


@pytest.mark.parametrize("policy", [
    dict(**FORCE_HEAL, bands_per_step=1),
    dict(check_every=2, loss_mult=0.0, loss_add=-1.0, bands_per_step=2),
    dict(check_every=3, loss_mult=0.0, loss_add=-1.0, reprogram=False),
], ids=["every-step", "two-a-step", "recalibrate-only"])
def test_heal_scheduler_matches_reference(lm, j_noop, policy):
    """The same trace, clock and policy through the port's runtime and the
    reference's record the same heal events, reprogrammed bands,
    recalibrations, probes and decode steps."""
    cfg, params, calib = lm
    j_cfg, j_params, j_manager = j_noop
    reqs = _trace(cfg, 3, seed=7, lens=(3, 7), new=(3, 6))
    kw = dict(max_slots=2, max_len=16)
    t_rt = ServeRuntime(cfg, params, manager=_noop_manager(lm),
                        clock=DriftClock(dt_per_step=4.0, update_every=2),
                        heal=HealPolicy(**policy), **kw)
    j_rt = JServeRuntime(
        j_cfg, j_params, manager=j_manager,
        clock=JDriftClock(dt_per_step=4.0, update_every=2),
        heal=JHealPolicy(**policy), **kw)
    _serve(t_rt, reqs), _serve(j_rt, reqs)
    keys = ("decode_steps", "heal_events", "bands_reprogrammed",
            "recalibrations")
    assert {k: t_rt.stats[k] for k in keys} == \
        {k: j_rt.stats[k] for k in keys}
    assert len(t_rt.stats["probe_losses"]) == \
        len(j_rt.stats["probe_losses"]) > 0
    assert t_rt.stats["heal_events"] > 0 and not t_rt._heal_queue


def test_mid_stream_reprogram_preserves_tokens(lm):
    """Requests admitted before, during and after heal events complete with
    the tokens of an unhealed run when aging changes no value."""
    cfg, params, _ = lm
    reqs = _trace(cfg, 6, seed=5, lens=(4, 6), new=(4, 8))
    outs = []
    for heal in (None, HealPolicy(**FORCE_HEAL, bands_per_step=1)):
        rt = ServeRuntime(cfg, params, manager=_noop_manager(lm),
                          max_slots=2, max_len=24, heal=heal)
        outs.append(_serve(rt, reqs))
        if heal is not None:
            s = rt.stats
            assert s["heal_events"] >= 1
            assert s["bands_reprogrammed"] >= 2
            assert s["recalibrations"] >= 1
    for uid in outs[0]:
        np.testing.assert_array_equal(outs[0][uid], outs[1][uid])


def test_eos_during_reprogram_race(trained):
    """A request whose EOS fires while the heal queue drains retires at the
    EOS token, and a request submitted during the drain serves correctly
    (on the trained LM, whose greedy stream does not repeat one token)."""
    cfg, params, _, _, calib = trained
    m = _noop_manager((cfg, params, calib))
    prompt = np.arange(5, dtype=np.int32) % cfg.vocab
    ref = decode_lm(cfg, params, torch.as_tensor(prompt)[None], 8,
                    pack=m.fresh_pack)[0].numpy()
    j = next(i for i in range(3, 8) if ref[i] not in ref[:i])
    eos = int(ref[j])
    rt = ServeRuntime(cfg, params, manager=m, max_slots=2, max_len=16,
                      eos_id=eos, heal=HealPolicy(**FORCE_HEAL,
                                                  bands_per_step=1))
    uid = rt.submit(prompt, max_new_tokens=8)
    done = {}
    for _ in range(64):
        for c in rt.step():
            done[c.uid] = c.tokens
        if uid in done:
            break
    np.testing.assert_array_equal(done[uid], ref[:j + 1])
    assert rt.stats["bands_reprogrammed"] >= 1
    uid2 = rt.submit(prompt, max_new_tokens=2)
    out2 = rt.run()
    np.testing.assert_array_equal(out2[uid2], ref[:2])
    assert not rt._heal_queue


def test_paged_heal_preserves_tokens(lm):
    """A healed paged runtime with inert aging serves exactly what the
    unhealed dense runtime serves (the radix cache is kept across swaps,
    as in the reference)."""
    cfg, params, _ = lm
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, cfg.vocab, size=9).astype(np.int32)
    reqs = []
    for i in range(4):
        p = rng.integers(0, cfg.vocab, size=int(rng.integers(5, 7))) \
            .astype(np.int32)
        if i % 2 == 0:
            p[:4] = prefix[:4]
        reqs.append((p, int(rng.integers(4, 6))))
    dense = ServeRuntime(cfg, params, pack=_noop_manager(lm).aged(1.0),
                         max_slots=2, max_len=16)
    paged = PagedServeRuntime(
        cfg, params, manager=_noop_manager(lm), max_slots=2, max_len=16,
        page_size=4, heal=HealPolicy(**FORCE_HEAL, bands_per_step=1))
    ref, got = _serve(dense, reqs), _serve(paged, reqs)
    paged.check()
    assert paged.stats["heal_events"] > 0
    assert paged.stats["bands_reprogrammed"] > 0
    for uid in ref:
        np.testing.assert_array_equal(ref[uid], got[uid])


# ---------------------------------------------------------------------------
# driftbench's gated claim on the trained smoke LM
# ---------------------------------------------------------------------------

#: benchmarks/driftbench.py's DRIFT_SPEC and healing trace
DRIFT_SPEC = A.design_a(error=E.state_proportional(0.05),
                        drift=E.power_law_drift(0.2, sigma_nu=0.3),
                        fault=E.stuck_faults(1e-5), fused="kernel")
N_REQUESTS, MAX_NEW, MAX_SLOTS, HEAL_HORIZON = 8, 8, 2, 256.0


def _serve_aging(cfg, params, calib, reqs, *, heal: bool):
    m = PackManager(cfg, params, DRIFT_SPEC, 1234, calib_tokens=calib)
    steps_est = N_REQUESTS * MAX_NEW / MAX_SLOTS
    clock = DriftClock(dt_per_step=HEAL_HORIZON / steps_est, update_every=8)
    policy = HealPolicy(check_every=8, bands_per_step=1) if heal else None
    rt = ServeRuntime(cfg, params, manager=m, max_slots=MAX_SLOTS,
                      max_len=24, clock=clock, heal=policy)
    out = _serve(rt, reqs)
    assert len(out) == len(reqs)
    return m.probe_loss(rt.pack), m.ref_loss, rt.stats


def test_driftbench_claim_heal_holds_tolerance(trained):
    """Served on a drift clock to t = 256: heal-on ends within ``ref * 1.35
    + 0.2`` of the fresh pack's probe loss (the tests/test_system.py
    tolerance), and heal-off breaks it."""
    cfg, params, _, _, _ = trained
    ds = SyntheticLM(cfg=j_smoke("qwen1.5-4b"), seq_len=32, global_batch=8,
                     seed=0)
    calib = np.asarray(ds.batch(998)["tokens"])       # lm_accuracy.CALIB_STEP
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, size=int(rng.integers(3, 9)))
             .astype(np.int32), MAX_NEW) for _ in range(N_REQUESTS)]
    off, ref, _ = _serve_aging(cfg, params, calib, reqs, heal=False)
    on, ref_on, s_on = _serve_aging(cfg, params, calib, reqs, heal=True)
    assert ref == ref_on
    assert on < ref * 1.35 + 0.2, (on, ref, s_on)
    assert off >= ref * 1.35 + 0.2, (off, ref)
    assert s_on["heal_events"] >= 1 and s_on["recalibrations"] >= 1


# ---------------------------------------------------------------------------
# resilient_step (tests/test_substrate.py's cases)
# ---------------------------------------------------------------------------


def test_resilient_step_retries_then_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("transient")
        return "ok"

    assert resilient_step(flaky, backoff_s=0.001) == "ok"
    assert calls["n"] == 3


def test_resilient_step_gives_up():
    def always_fails():
        raise TimeoutError("dead node")

    with pytest.raises(StepFailed):
        resilient_step(always_fails, max_retries=2, backoff_s=0.001)


def test_resilient_step_deterministic_errors_reraise_immediately():
    calls = {"n": 0}

    def deterministic():
        calls["n"] += 1
        raise RuntimeError("rank mismatch: expected 2, got 3")

    with pytest.raises(RuntimeError, match="rank mismatch"):
        resilient_step(deterministic, max_retries=5, backoff_s=0.001)
    assert calls["n"] == 1

    def missing():
        calls["n"] += 1
        raise FileNotFoundError("no such checkpoint")

    with pytest.raises(FileNotFoundError):
        resilient_step(missing, max_retries=5, backoff_s=0.001)
    assert calls["n"] == 2


def test_resilient_step_transient_xla_messages():
    class XlaRuntimeError(RuntimeError):     # stand-in, matched by name
        pass

    assert is_transient(XlaRuntimeError("UNAVAILABLE: socket closed"))
    assert is_transient(XlaRuntimeError("DEADLINE_EXCEEDED: heartbeat"))
    assert not is_transient(XlaRuntimeError("INVALID_ARGUMENT: rank"))
    assert not is_transient(RuntimeError("UNAVAILABLE"))  # name-gated
    assert is_transient(ConnectionResetError("peer reset"))
    assert not is_transient(ValueError("bad field"))


@pytest.mark.parametrize("err", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.AcceleratorError("CUDA error: unspecified launch failure"),
    RuntimeError("CUDA error: UNAVAILABLE"),
], ids=["runtime-error", "accelerator-error", "transient-word"])
def test_resilient_step_never_retries_a_cuda_error(err):
    """A failed launch surfaces as a ``RuntimeError`` or
    ``torch.AcceleratorError``: it re-raises at once, with no retry, even
    when its message carries a transient status word."""
    calls = []

    def launch():
        calls.append(1)
        raise err

    with pytest.raises(type(err)) as info:
        resilient_step(launch, max_retries=5, backoff_s=0.001,
                       on_retry=lambda *a: calls.append("retry"))
    assert info.value is err and calls == [1]
    assert not is_transient(err)


def test_straggler_monitor_flags_outliers():
    events = []
    mon = StragglerMonitor(k_sigma=3.0, min_samples=10,
                           on_straggler=lambda s, t: events.append((s, t)))
    for _ in range(20):
        mon.record(0.1 + np.random.RandomState(1).rand() * 0.001)
    assert mon.record(1.5) is True       # injected straggler
    assert events == [(21, 1.5)]


def test_heartbeat_touches_its_file(tmp_path):
    hb = Heartbeat(str(tmp_path / "alive"), interval_s=0.01)
    hb.start()
    try:
        assert (tmp_path / "alive").exists() and hb.age() < 5.0
    finally:
        hb.stop()
