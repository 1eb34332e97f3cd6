"""The port's core op (``repro_torch.core``) against the JAX reference
(``repro.core``) on identical numpy inputs.

Integer stages — weight codes, quantized activations, bit planes — and the
error-free conductances must match exactly.  The composed
``analog_matmul`` runs on the *same* programmed conductances (exported
from the reference), so only float reassociation separates the two; it is
held to the bound of ``repro_torch.kernels.tolerance`` (2 ulp or 0.25 of
a dequant grid step, one-code ADC flips only next to a rounding edge).
Design E (offset mapping, digital accumulation, four slices) has no fused
form for that check, so it is held by the quantizer bound of
``tests/test_kernels.py``: at most one ADC code of its heaviest term
anywhere, and 98% of outputs tight.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as j_adc
from repro.core import analog as JA
from repro.core import calibrate as j_cal
from repro.core import errors as JE
from repro.core import mapping as j_map
from repro.core import quant as j_quant
from repro_torch.core import adc as t_adc
from repro_torch.core import analog as TA
from repro_torch.core import errors as TE
from repro_torch.core import mapping as t_map
from repro_torch.core import quant as t_quant
from repro_torch.kernels import tolerance

SPECS = {
    "design_a": (JA.design_a(), TA.design_a()),
    "design_e": (JA.design_e(), TA.design_e()),
    "sliced_diff": tuple(
        dataclasses.replace(
            mod.design_a(),
            mapping=mapmod.MappingConfig(scheme="differential", weight_bits=8,
                                         bits_per_cell=2, on_off_ratio=1e4))
        for mod, mapmod in ((JA, j_map), (TA, t_map))),
    "digital_accum": (dataclasses.replace(JA.design_a(), input_accum="digital"),
                      dataclasses.replace(TA.design_a(), input_accum="digital")),
}


def _weights(seed=0, k=200, n=48):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)) * 0.1).astype(np.float32)


def _acts(seed=1, m=6, k=200):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k)).astype(np.float32)


@pytest.mark.parametrize("tag", list(SPECS))
def test_codes_and_conductances_exact(tag):
    js, ts = SPECS[tag]
    w = _weights()
    jp = JA.program_codes(jnp.asarray(w), js)
    tp = TA.program_codes(torch.as_tensor(w), ts)
    for field in ("c_pos", "c_neg", "c_unit"):
        a, b = getattr(jp.codes, field), getattr(tp.codes, field)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert float(jp.w_scale) == float(tp.w_scale)
    jw = JA.program_from_codes(jp, js, None)
    tw = TA.program_from_codes(tp, ts, None)
    np.testing.assert_array_equal(np.asarray(jw.g_pos), tw.g_pos.numpy())
    if jw.g_neg is not None:
        np.testing.assert_array_equal(np.asarray(jw.g_neg), tw.g_neg.numpy())


@pytest.mark.parametrize("signed,clip", [(True, None), (True, 1.3),
                                         (False, 2.0)])
def test_quantized_acts_and_bit_planes_exact(signed, clip):
    x = _acts()
    if not signed:
        x = np.abs(x)
    kw = {} if clip is None else {"clip_hi": np.float32(clip)}
    jq = j_quant.quantize_acts(jnp.asarray(x), 8, signed=signed,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    tq = t_quant.quantize_acts(torch.as_tensor(x), 8, signed=signed,
                               **{k: torch.as_tensor(v) for k, v in kw.items()})
    np.testing.assert_array_equal(np.asarray(jq.values), tq.values.numpy())
    assert float(jq.scale) == float(tq.scale)
    nb = j_quant.n_input_planes(8, signed)
    np.testing.assert_array_equal(
        np.asarray(j_quant.bit_planes(jq.values, nb, signed=signed)),
        t_quant.bit_planes(tq.values, nb, signed=signed).numpy())


def test_calibrate_act_range_matches():
    x = _acts(seed=4, m=32, k=64) * 3.0
    _, j_hi = j_quant.calibrate_act_range(jnp.asarray(x))
    _, t_hi = t_quant.calibrate_act_range(torch.as_tensor(x))
    np.testing.assert_allclose(float(t_hi), float(j_hi), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4096, 8192, 40001])
def test_sort_based_percentile_matches_jnp(n):
    """Against ``jnp.percentile`` compiled with its quantile fixed, the
    form in which the reference calibrates (inside the layer scan)."""
    rng = np.random.default_rng(n)
    v = (rng.standard_normal(n) * 30).astype(np.float32)
    for q in (0.01, 50.0, 99.99):
        want = float(jax.jit(lambda a, q=q: jnp.percentile(a, q))(
            jnp.asarray(v)))
        got = float(t_adc.percentile(torch.as_tensor(v), q))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    lo_j, hi_j = jax.jit(j_adc.range_from_samples)(jnp.asarray(v))
    lo_t, hi_t = t_adc.range_from_samples(torch.as_tensor(v))
    np.testing.assert_allclose([float(lo_t), float(hi_t)],
                               [float(lo_j), float(hi_j)], rtol=1e-6,
                               atol=1e-6)


def _programmed_pair(tag, seed=3):
    """A JAX-programmed (noisy) matrix, its port copy, and JAX-calibrated
    ADC ranges."""
    js, ts = SPECS[tag]
    js = dataclasses.replace(js, error=JE.state_proportional(0.05))
    ts = dataclasses.replace(ts, error=TE.state_proportional(0.05))
    w, x = _weights(seed), _acts(seed + 1)
    jaw = JA.program(jnp.asarray(w), js, key=jax.random.PRNGKey(seed))
    lo, hi = j_cal.calibrate_adc_for_matmul(jnp.asarray(x), jaw, js)

    def t(a):
        return None if a is None else torch.as_tensor(np.array(a))

    taw = TA.AnalogWeights(g_pos=t(jaw.g_pos), g_neg=t(jaw.g_neg),
                           g_unit=t(jaw.g_unit), w_scale=t(jaw.w_scale),
                           k=jaw.k, n=jaw.n)
    return js, ts, jaw, taw, x, lo, hi


@pytest.mark.parametrize("tag", ["design_a", "sliced_diff", "digital_accum"])
def test_composed_analog_matmul_within_bound(tag):
    js, ts, jaw, taw, x, lo, hi = _programmed_pair(tag)
    y_j = JA.analog_matmul(jnp.asarray(x), jaw, js, adc_lo=lo, adc_hi=hi)
    y_t = TA.analog_matmul(torch.as_tensor(x), taw, ts,
                           adc_lo=torch.as_tensor(np.array(lo)),
                           adc_hi=torch.as_tensor(np.array(hi)))
    # the composed differential chain computes the fused kernel's function:
    # hold it with the fused bound, edges judged on the port's own values
    xq = t_quant.quantize_acts(torch.as_tensor(x), ts.input_bits)
    k = x.shape[1]
    p, rows = ts.n_partitions(k), ts.rows_per_partition(k)
    x_parts = torch.nn.functional.pad(xq.values, (0, p * rows - k)) \
        .reshape(-1, p, rows)
    m = ts.mapping
    scale = (m.levels_per_cell - 1) / (1.0 - m.g_min) * taw.w_scale * xq.scale
    n_bits = None if ts.input_accum == "analog" else ts.n_planes
    r = tolerance.fused_mvm_check(
        torch.as_tensor(np.array(y_j)), y_t, x_parts, taw.g_pos, taw.g_neg,
        torch.as_tensor(np.array(lo)), torch.as_tensor(np.array(hi)),
        scale, adc_bits=ts.adc.bits, cell_bits=m.cell_bits, n_bits=n_bits)
    assert r["ok"], r


def test_composed_design_e_within_quantizer_bound():
    js, ts, jaw, taw, x, lo, hi = _programmed_pair("design_e")
    y_j = np.asarray(JA.analog_matmul(jnp.asarray(x), jaw, js, adc_lo=lo,
                                      adc_hi=hi))
    y_t = TA.analog_matmul(torch.as_tensor(x), taw, ts,
                           adc_lo=torch.as_tensor(np.array(lo)),
                           adc_hi=torch.as_tensor(np.array(hi))).numpy()
    m = ts.mapping
    xq = t_quant.quantize_acts(torch.as_tensor(x), ts.input_bits)
    lsb = float(np.max((np.asarray(hi) - np.asarray(lo)) / (2 ** ts.adc.bits - 1)))
    top_w = 2.0 ** (m.cell_bits * (m.n_slices - 1) + ts.n_planes - 1)
    flip = lsb * (m.levels_per_cell - 1) / (1.0 - m.g_min) * top_w \
        * float(taw.w_scale) * float(xq.scale)
    np.testing.assert_allclose(y_t, y_j, atol=flip * 1.001, rtol=0)
    tight = np.isclose(y_t, y_j, rtol=1e-4, atol=flip * 1e-3)
    assert tight.mean() >= 0.98


def test_calibrated_adc_ranges_match():
    js, ts, jaw, taw, x, lo, hi = _programmed_pair("sliced_diff", seed=5)
    from repro_torch.core import calibrate as t_cal

    t_lo, t_hi = t_cal.calibrate_adc_for_matmul(torch.as_tensor(x), taw, ts)
    np.testing.assert_allclose(t_lo.numpy(), np.asarray(lo), rtol=1e-5)
    np.testing.assert_allclose(t_hi.numpy(), np.asarray(hi), rtol=1e-5)


def test_programming_noise_statistics():
    """torch.Generator cannot replay jax.random: the draws are held by
    their statistics — zero mean, sigma = alpha * g for state-proportional
    error — and by reproducibility under a fixed seed."""
    spec = dataclasses.replace(TA.design_a(), error=TE.state_proportional(0.1))
    w = torch.as_tensor(_weights(seed=9, k=400, n=300))
    clean = TA.program(w, spec, seed=None)
    noisy = TA.program(w, spec, seed=11)
    again = TA.program(w, spec, seed=11)
    assert torch.equal(noisy.g_pos, again.g_pos)
    g = clean.g_pos
    on = g > 0.05
    z = (noisy.g_pos - g)[on] / (0.1 * g[on])
    assert abs(float(z.mean())) < 0.02
    assert abs(float(z.std()) - 1.0) < 0.02


def test_unported_paths_raise():
    """The paths once unported now run.  Drift and stuck-cell faults build
    and age a programmed matrix: values equal at the fresh age, decayed or
    stuck at an older one (tests/test_torch_drift.py holds their
    statistics against the reference).  Parasitic bit-line resistance and
    the legacy ``use_pallas`` route return finite results of the right
    shape, the parasitic one away from the ideal chain's (voltage sag moves
    the outputs), the legacy one equal to the composed chain's
    (tests/test_torch_parasitics.py holds both against the reference)."""
    from repro_torch.core import calibrate as t_cal

    drift = TE.DriftModel(kind="power_law", nu=0.05)
    fault = TE.FaultModel(kind="stuck", rate=0.1)
    w = torch.as_tensor(_weights())
    for model in (drift, fault):
        spec = TA.design_a(**{"drift" if model is drift else "fault": model})
        assert spec.aging_on
        fresh = TA.program(w, spec, seed=3)
        old = dataclasses.replace(spec, **{
            "drift" if model is drift else "fault":
                dataclasses.replace(model, t=64.0)})
        aged = TA.program(w, old, seed=3)
        assert torch.equal(TA.program(w, TA.design_a(), seed=3).g_pos,
                           fresh.g_pos)
        assert aged.g_pos.shape == fresh.g_pos.shape
        assert not torch.equal(aged.g_pos, fresh.g_pos)
    with pytest.raises(ValueError, match="DriftModel.kind"):
        TE.DriftModel(kind="linear")
    with pytest.raises(ValueError, match="FaultModel.kind"):
        TE.FaultModel(kind="open")
    x = torch.as_tensor(_acts())
    ideal = TA.design_a()
    aw = TA.program(w, ideal)
    lo, hi = t_cal.calibrate_adc_for_matmul(x, aw, ideal)
    y_ideal = TA.analog_matmul(x, aw, ideal, adc_lo=lo, adc_hi=hi)
    par = dataclasses.replace(ideal, r_hat=1e-3)
    p_lo, p_hi = t_cal.calibrate_adc_for_matmul(x, aw, par)
    y = TA.analog_matmul(x, aw, par, adc_lo=p_lo, adc_hi=p_hi)
    assert y.shape == (6, 48) and bool(torch.isfinite(y).all())
    assert not torch.equal(y, y_ideal)
    legacy = dataclasses.replace(ideal, use_pallas=True)
    y = TA.analog_matmul(x, aw, legacy, adc_lo=lo, adc_hi=hi)
    assert y.shape == (6, 48) and bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, y_ideal, rtol=1e-5, atol=1e-5)


def test_fuse_signature_and_routing_match():
    for tag, (js, ts) in SPECS.items():
        for mode in ("off", "kernel", "oracle"):
            jf = dataclasses.replace(js, fused=mode)
            tf = dataclasses.replace(ts, fused=mode)
            assert JA.fuse_signature(jf) == TA.fuse_signature(tf), (tag, mode)
            for collect in (False, True):
                assert (JA._maybe_pallas_fastpath(jf, collect)
                        == TA._maybe_pallas_fastpath(tf, collect))
