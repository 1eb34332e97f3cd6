"""Bit-line parasitics and the legacy ``use_pallas`` route in the port,
against the JAX reference on identical numpy inputs.

* Plain kernel versions against the reference's functions, on the grids of
  ``tests/test_kernels.py`` (``repro_torch.kernels.tolerance``):
  Thomas currents within 2 ulp of ``|I|`` (they take the same rounded
  operations in the same order, so they are expected to agree to the bit);
  ADC'd outputs within the fused bound (2 ulp or 0.25 of the grid step,
  one-code flips counted and allowed only within 4 ulp of a rounding
  edge); currents against a dense solve and Kirchhoff's current law.
* Routing: the parasitic and ``use_pallas`` specs route the same way in
  both packages and give the same outputs within the bound on the
  reference's programmed conductances and ranges.
* The slice: the smoke qwen1.5-4b under route P1 (Design A, ``r_hat``
  1e-4, ``fused="kernel"``) and route P2 (``use_pallas=True,
  fused="off"`` at ``r_hat`` 1e-4 and 0), on a pack programmed and
  calibrated by the reference and carried across with
  ``interop.pack_from_numpy``: every analog site held to the bound of its
  kernel against the reference on its operands, logits within the bound
  of ``tests/test_torch_model.py`` away from positions downstream of a
  rounding-edge case, greedy tokens identical up to near ties, and the
  port's ``ServeRuntime`` equal to its ``decode_lm`` at 1.0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import analog as JA
from repro.core import calibrate as j_cal
from repro.core import errors as JE
from repro.core import parasitics as j_par
from repro.core.mapping import MappingConfig as JMapping
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import transformer as JT
from repro.serve import calibrate_lm as j_calibrate
from repro.serve import decode_lm as j_decode
from repro.serve import program_lm as j_program
from repro_torch import interop
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import analog as TA
from repro_torch.core import calibrate as t_cal
from repro_torch.core import errors as TE
from repro_torch.core import parasitics as t_par
from repro_torch.core import quant as t_quant
from repro_torch.core.mapping import MappingConfig as TMapping
from repro_torch.kernels import analog_mvm as t_mvm
from repro_torch.kernels import bitline as t_bl
from repro_torch.kernels import fused as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import tolerance
from repro_torch.kernels.tolerance import (BITLINE_DENSE_GRID, BITLINE_GRID,
                                           FUSED_PARASITIC_GRID, LEGACY_GAIN,
                                           LEGACY_GRID, LEGACY_PARASITIC_GRID,
                                           LEGACY_RANGE, bitline_case,
                                           fused_parasitic_case, legacy_case)
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeRuntime
from repro_torch.serve import decode_lm as t_decode
from test_torch_cuda import _ids
from test_torch_model import NPZ, _export_pack, _head_grid, _np_tree


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# plain kernel versions against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,r", BITLINE_GRID, ids=_ids(BITLINE_GRID))
def test_plain_bitline_matches_jax(m, k, n, r):
    """Against both the reference's core solver and its bit-line kernel (in
    interpret mode); the batched wrapper (one call over several arrays)
    gives each array the unbatched currents."""
    x, g = bitline_case(m, k, n)
    want_core = np.asarray(j_par.bitline_currents(*_j(g, x), r))
    want_kern = np.asarray(j_ops.bitline_mvm(*_j(g, x), r))
    tg, tx = _t(g, x)
    got = t_ops.bitline_mvm(tg, tx, r)
    assert got.shape == (m, n) and got.dtype == torch.float32
    for want in (want_core, want_kern):
        res = tolerance.bitline_check(got, torch.as_tensor(want))
        assert res["ok"], res
    batched = t_ops.bitline_mvm(torch.stack([tg, 0.5 * tg]),
                                tx[None], r)
    assert torch.equal(batched[0], got)
    assert torch.equal(batched[1], t_ops.bitline_mvm(0.5 * tg, tx, r))


@pytest.mark.parametrize("m,k,n,r", BITLINE_DENSE_GRID,
                         ids=_ids(BITLINE_DENSE_GRID))
def test_bitline_against_dense_solve_and_kirchhoff(m, k, n, r):
    """Element by element against a dense solve (the port's and the
    reference's), and the bottom-segment current equal to the injected
    cell currents."""
    x, g = bitline_case(m, k, n, seed=7)
    tx, tg = _t(x, g)
    got = t_par.bitline_currents(tg, tx, r).numpy()
    for mm in range(m):
        for nn in range(n):
            v = t_par.bitline_voltages_dense(tg[:, nn], tx[mm], r)
            v_j = np.asarray(j_par.bitline_voltages_dense(
                jnp.asarray(g[:, nn]), jnp.asarray(x[mm]), r))
            np.testing.assert_allclose(v.numpy(), v_j, rtol=1e-4, atol=1e-9)
            np.testing.assert_allclose(got[mm, nn], float(v[-1]) / r,
                                       rtol=1e-4)
            np.testing.assert_allclose(
                float(v[-1]) / r,
                float(t_par.injected_current(tg[:, nn], tx[mm], v)),
                rtol=1e-3, atol=1e-5)


def test_parasitics_only_reduce_current_magnitude():
    """Voltage sag pulls unipolar outputs toward zero (Sec. 8: 'downward')."""
    rng = np.random.default_rng(3)
    g = torch.as_tensor(rng.random((16, 4)).astype(np.float32))
    x = torch.as_tensor((rng.random((3, 16)) > 0.5).astype(np.float32))
    sag = t_par.bitline_currents(g, x, 1e-3)
    assert bool((sag <= x @ g + 1e-6).all()) and bool((sag >= 0).all())


def test_bitline_zero_r_is_ideal():
    x, g = _t(*bitline_case(8, 32, 16, seed=5))
    for zero in (0.0, 0, np.float32(0.0), torch.zeros(())):
        assert t_par.parasitics_off(zero)
        torch.testing.assert_close(t_ops.bitline_mvm(g, x, zero), x @ g)
        torch.testing.assert_close(t_par.bitline_currents(g, x, zero), x @ g)
        with pytest.raises(ValueError, match="one \\(K, N\\) array"):
            t_ops.bitline_mvm(g[None].expand(3, -1, -1), x[None], zero)
    assert not TA.AnalogSpec(r_hat=np.float32(0.0)).parasitics_on
    assert TA.AnalogSpec(r_hat=np.float32(1e-4)).parasitics_on


def test_bitline_sweep_chunks_over_columns(monkeypatch):
    """Chunking the sweep over columns (the full-width memory cap) leaves
    every current unchanged."""
    x, g = _t(*bitline_case(6, 40, 33, seed=2))
    whole = t_par.bottom_current(x, g, 1e-3)
    monkeypatch.setattr(t_par, "MAX_ELEMS", 6 * 5)
    assert torch.equal(t_par.bottom_current(x, g, 1e-3), whole)


@pytest.mark.parametrize("m,p,s,rows,n,r", FUSED_PARASITIC_GRID,
                         ids=_ids(FUSED_PARASITIC_GRID))
def test_plain_fused_parasitic_matches_jax(m, p, s, rows, n, r):
    """Against the reference's fused parasitic oracle and its Pallas kernel
    in interpret mode, ``r_hat`` traced as the reference's tests trace it."""
    arrs = fused_parasitic_case(m, p, s, rows, n)
    kw = dict(adc_bits=8, cell_bits=2 if s > 1 else 7, n_bits=7)
    scale = np.float32(3e-4)
    x, gp, gm, lo, hi = _t(*arrs)
    got = t_ops.fused_mvm_parasitic(x, gp, gm, r_hat=r, adc_lo=lo, adc_hi=hi,
                                    scale=torch.tensor(scale), **kw)
    assert got.shape == (m, n) and got.dtype == torch.float32
    for backend in ("oracle", "kernel"):
        f = jax.jit(lambda rr, b=backend: j_ops.fused_mvm_parasitic(
            *_j(*arrs[:3]), r_hat=rr, adc_lo=jnp.asarray(arrs[3]),
            adc_hi=jnp.asarray(arrs[4]), scale=jnp.float32(scale),
            backend=b, **kw))
        want = torch.as_tensor(np.array(f(jnp.float32(r))))
        res = tolerance.fused_mvm_parasitic_check(
            want, got, x, gp, gm, r, lo, hi, torch.tensor(scale), **kw)
        assert res["ok"], (backend, res)


@pytest.mark.parametrize("m,p,rows,n", LEGACY_PARASITIC_GRID,
                         ids=_ids(LEGACY_PARASITIC_GRID))
def test_plain_legacy_parasitic_matches_jax(m, p, rows, n):
    x, gp, gm = legacy_case(m, p, rows, n)
    lo, hi = (np.float32(v) for v in LEGACY_RANGE)
    kw = dict(r_hat=1e-3, n_bits=7, adc_bits=8, gain=LEGACY_GAIN)
    want = j_ref.analog_mvm_parasitic_diff(*_j(x, gp, gm), adc_lo=lo,
                                           adc_hi=hi, **kw)
    tx, tgp, tgm = _t(x, gp, gm)
    got = t_ops.analog_mvm_parasitic(tx, tgp, tgm, adc_lo=torch.tensor(lo),
                                     adc_hi=torch.tensor(hi), **kw)
    assert got.shape == (m, n)
    res = tolerance.analog_mvm_check(
        torch.as_tensor(np.array(want)), got, tx, tgp, tgm, lo, hi,
        LEGACY_GAIN, adc_bits=8, r_hat=1e-3, n_bits=7)
    assert res["ok"], res
    # the (S=1, P, rows, N) stacks analog_matmul passes take the same path
    assert torch.equal(t_ops.analog_mvm_parasitic(
        tx, tgp[None], tgm[None], adc_lo=torch.tensor(lo),
        adc_hi=torch.tensor(hi), **kw), got)


@pytest.mark.parametrize("m,p,rows,n,adc_bits", LEGACY_GRID,
                         ids=_ids(LEGACY_GRID))
def test_plain_legacy_mvm_matches_jax(m, p, rows, n, adc_bits):
    """The port sums each dot in ascending row order, the reference's
    einsum in its BLAS's blocked order.  The two pre-ADC values must agree
    within the bound on reordering a float32 sum of ``rows`` products,
    ``rows * 2**-24 * sum |x g|``; the outputs within the fused bound, a
    one-code flip allowed where the plain value lies within 4 ulp of the
    rounding edge or the reference's own pre-ADC value lies across it
    (a long dot whose terms cancel can land the two orders many ulps of
    the result apart: (128, 1, 1152, 256) does)."""
    x, gp, gm = legacy_case(m, p, rows, n, seed=m * 7 + p)
    lo, hi = (np.float32(v) for v in LEGACY_RANGE)
    kw = dict(adc_bits=adc_bits, gain=LEGACY_GAIN)
    want = j_ref.analog_mvm_diff(*_j(x, gp, gm), adc_lo=lo, adc_hi=hi, **kw)
    v_ref = np.asarray(jnp.einsum("mpr,prn->pmn", *_j(x, gp - gm),
                                  precision=jax.lax.Precision.HIGHEST))
    tx, tgp, tgm = _t(x, gp, gm)
    got = t_ops.analog_mvm(tx, tgp, tgm, adc_lo=torch.tensor(lo),
                           adc_hi=torch.tensor(hi), **kw)
    assert got.shape == (m, n)
    v = t_ref.fused_pre_adc(tx, tgp[None], tgm[None], None)[:, 0, 0].numpy()
    reorder = rows * 2.0 ** -24 * np.einsum(
        "mpr,prn->pmn", np.abs(x).astype(np.float64),
        np.abs(gp - gm).astype(np.float64))
    assert (np.abs(v.astype(np.float64) - v_ref) <= reorder).all()
    res = tolerance.analog_mvm_check(
        torch.as_tensor(np.array(want)), got, tx, tgp, tgm, lo, hi,
        LEGACY_GAIN, adc_bits=adc_bits, v_other=torch.as_tensor(v_ref))
    assert res["ok"], res


@pytest.mark.parametrize("which", ["analog_mvm", "analog_mvm_parasitic"])
def test_plain_legacy_is_batch_invariant(which):
    """Each output row is the same bits whichever rows share the call."""
    x, gp, gm = _t(*legacy_case(9, 2, 40, 13, seed=4))
    kw = dict(adc_lo=torch.tensor(-50.0), adc_hi=torch.tensor(50.0),
              adc_bits=8, gain=LEGACY_GAIN)
    if which == "analog_mvm_parasitic":
        kw.update(r_hat=1e-3, n_bits=7)
    f = getattr(t_ops, which)
    full = f(x, gp, gm, **kw)
    for i in (0, 4, 8):
        assert torch.equal(f(x[i:i + 1], gp, gm, **kw), full[i:i + 1])


def test_new_wrappers_refuse_bad_backends_devices_and_slices():
    x, gp, gm = _t(*legacy_case(2, 1, 8, 4, seed=0))
    lo, hi = torch.tensor(-50.0), torch.tensor(50.0)
    with pytest.raises(ValueError, match="backend"):
        t_ops.analog_mvm(x, gp, gm, adc_lo=lo, adc_hi=hi, adc_bits=8,
                         gain=1.0, backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        t_ops.bitline_mvm(gp[0], x[:, 0], 1e-3, backend="mosaic")
    with pytest.raises(ValueError, match="unsliced"):
        t_ops.analog_mvm(x, torch.stack([gp, gp]), torch.stack([gm, gm]),
                         adc_lo=lo, adc_hi=hi, adc_bits=8, gain=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        t_mvm.analog_mvm_diff_cuda(x, gp, gm, lo, hi, adc_bits=8, gain=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        t_bl.analog_bitline_diff_cuda(x, gp, gm, torch.tensor(1e-3), lo, hi,
                                      n_bits=7, adc_bits=8, gain=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        t_bl.bitline_mvm_cuda(gp, x.permute(1, 0, 2).contiguous(),
                              torch.tensor(1e-3))
    with pytest.raises(ValueError, match="CUDA"):
        t_fused.fused_mvm_parasitic_cuda(
            x, gp[None], gm[None], torch.tensor(1e-3), lo.reshape(1),
            hi.reshape(1), torch.tensor(1.0), adc_bits=8, cell_bits=7,
            n_bits=7)


# ---------------------------------------------------------------------------
# routing through analog_matmul
# ---------------------------------------------------------------------------


def _specs(mod, mapmod):
    base = mod.design_a()
    sliced = dataclasses.replace(
        base, mapping=mapmod(scheme="differential", weight_bits=8,
                             bits_per_cell=2, on_off_ratio=1e4))
    return {
        # the ROUTED/REFUSED parasitic specs of test_fastpath_routing.py
        "designA_parasitic": dataclasses.replace(base, r_hat=1e-4),
        "parasitic_digital": dataclasses.replace(base, r_hat=1e-4,
                                                 input_accum="digital"),
        "sliced_parasitic": dataclasses.replace(sliced, r_hat=1e-4),
        # the legacy use_pallas route: Design A with and without
        # parasitics, and a sliced spec it refuses
        "pallas": dataclasses.replace(base, use_pallas=True),
        "pallas_parasitic": dataclasses.replace(base, use_pallas=True,
                                                r_hat=1e-4),
        "pallas_sliced_parasitic": dataclasses.replace(sliced,
                                                       use_pallas=True,
                                                       r_hat=1e-4),
    }


J_SPECS = _specs(JA, JMapping)
T_SPECS = _specs(TA, TMapping)


@pytest.mark.parametrize("tag", list(T_SPECS))
def test_parasitic_routing_matches(tag):
    for mode in ("off", "kernel", "oracle"):
        js = dataclasses.replace(J_SPECS[tag], fused=mode)
        ts = dataclasses.replace(T_SPECS[tag], fused=mode)
        assert JA.fuse_signature(js) == TA.fuse_signature(ts), (tag, mode)
        for collect in (False, True):
            assert (JA._maybe_pallas_fastpath(js, collect)
                    == TA._maybe_pallas_fastpath(ts, collect)), (tag, mode)


def _pair(tag, seed=3, m=4, k=200, n=48):
    """A reference-programmed (noisy) matrix and its port copy, inputs, and
    reference-calibrated ranges (compiled, as the serving engine
    calibrates)."""
    js = dataclasses.replace(J_SPECS[tag], error=JE.state_proportional(0.05))
    ts = dataclasses.replace(T_SPECS[tag], error=TE.state_proportional(0.05))
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jaw = JA.program(jnp.asarray(w), js, key=jax.random.PRNGKey(seed))
    lo, hi = jax.jit(lambda xx: j_cal.calibrate_adc_for_matmul(xx, jaw, js))(
        jnp.asarray(x))
    taw = TA.AnalogWeights(
        g_pos=torch.as_tensor(np.array(jaw.g_pos)),
        g_neg=torch.as_tensor(np.array(jaw.g_neg)), g_unit=None,
        w_scale=torch.as_tensor(np.array(jaw.w_scale)), k=jaw.k, n=jaw.n)
    return js, ts, jaw, taw, x, lo, hi


def _check_output(ts, taw, x, y_j, y_t, lo, hi):
    """Hold an analog_matmul output against the reference's under the
    fused bound, the terms taken from the port's own quantized inputs."""
    xq = t_quant.quantize_acts(torch.as_tensor(x), ts.input_bits)
    k = x.shape[1]
    p, rows = ts.n_partitions(k), ts.rows_per_partition(k)
    x_parts = torch.nn.functional.pad(xq.values, (0, p * rows - k)) \
        .reshape(-1, p, rows)
    m = ts.mapping
    scale = (m.levels_per_cell - 1) / (1.0 - m.g_min) * taw.w_scale * xq.scale
    args = (torch.as_tensor(np.array(y_j)), y_t, x_parts, taw.g_pos,
            taw.g_neg)
    lo, hi = _t(lo, hi)
    if ts.parasitics_on and ts.input_accum == "analog":
        return tolerance.fused_mvm_parasitic_check(
            *args, ts.r_hat, lo, hi, scale, adc_bits=ts.adc.bits,
            cell_bits=m.cell_bits, n_bits=ts.n_planes)
    n_bits = None if ts.input_accum == "analog" else ts.n_planes
    return tolerance.fused_mvm_check(*args, lo, hi, scale,
                                     adc_bits=ts.adc.bits,
                                     cell_bits=m.cell_bits, n_bits=n_bits)


ROUTE_CASES = [(tag, mode) for tag in ("designA_parasitic",
                                       "sliced_parasitic")
               for mode in ("off", "kernel", "oracle")] + [
    ("pallas", "off"), ("pallas_parasitic", "off"),
    ("pallas_sliced_parasitic", "off")]


@pytest.mark.parametrize("tag,mode", ROUTE_CASES,
                         ids=[f"{t}-{m}" for t, m in ROUTE_CASES])
def test_parasitic_outputs_match(tag, mode):
    """Fused (kernel, oracle), composed and legacy routes against the
    reference on its programmed conductances and calibrated ranges."""
    js, ts, jaw, taw, x, lo, hi = _pair(tag)
    js = dataclasses.replace(js, fused=mode)
    ts = dataclasses.replace(ts, fused=mode)
    y_j = jax.jit(lambda xx: JA.analog_matmul(xx, jaw, js, adc_lo=lo,
                                              adc_hi=hi))(jnp.asarray(x))
    y_t = TA.analog_matmul(torch.as_tensor(x), taw, ts,
                           adc_lo=torch.as_tensor(np.array(lo)),
                           adc_hi=torch.as_tensor(np.array(hi)))
    assert y_t.shape == (4, 48)
    res = _check_output(ts, taw, x, y_j, y_t, lo, hi)
    assert res["ok"], res


def test_parasitic_digital_composes():
    """Digital accumulation under parasitics has no fused form: every mode
    falls back to the composed chain, bit for bit, and that chain agrees
    with the reference's."""
    js, ts, jaw, taw, x, lo, hi = _pair("parasitic_digital")
    tlo, thi = _t(lo, hi)
    y_off = TA.analog_matmul(torch.as_tensor(x), taw, ts, adc_lo=tlo,
                             adc_hi=thi)
    for mode in ("kernel", "oracle"):
        assert TA.fuse_signature(dataclasses.replace(ts, fused=mode)) is None
        assert torch.equal(TA.analog_matmul(
            torch.as_tensor(x), taw, dataclasses.replace(ts, fused=mode),
            adc_lo=tlo, adc_hi=thi), y_off)
    y_j = JA.analog_matmul(jnp.asarray(x), jaw, js, adc_lo=lo, adc_hi=hi)
    res = _check_output(ts, taw, x, y_j, y_off, lo, hi)
    assert res["ok"], res


@pytest.mark.parametrize("tag", ["designA_parasitic", "pallas_parasitic"])
def test_parasitic_calibrated_ranges_match(tag):
    """Calibration collects through the composed chain: under ``use_pallas``
    its bit-line solves go through ``ops.bitline_mvm``.  Ranges within
    1e-5 of the reference's, compiled as the serving engine runs it."""
    js, ts, jaw, taw, x, lo, hi = _pair(tag, m=64)
    t_lo, t_hi = t_cal.calibrate_adc_for_matmul(torch.as_tensor(x), taw, ts)
    np.testing.assert_allclose(t_lo.numpy(), np.asarray(lo), rtol=1e-5)
    np.testing.assert_allclose(t_hi.numpy(), np.asarray(hi), rtol=1e-5)


def test_use_pallas_calibration_runs_one_bitline_launch_per_line(monkeypatch):
    """The reference vmaps its bit-line kernel over (slice, partition); the
    port covers every array of a line in one call."""
    _, ts, _, taw, x, _, _ = _pair("pallas_sliced_parasitic")
    calls = []
    plain = t_ref.bitline_mvm

    def counting(g, xp, r_hat):
        calls.append((tuple(g.shape), tuple(xp.shape)))
        return plain(g, xp, r_hat)

    monkeypatch.setattr(t_ref, "bitline_mvm", counting)
    TA.analog_matmul(torch.as_tensor(x), taw, ts, collect=True)
    s, p, rows = taw.g_pos.shape[:3]
    assert calls == [((s * p, rows, 48), (p, ts.n_planes * 4, rows))] * 2


# ---------------------------------------------------------------------------
# the slice: smoke qwen1.5-4b served through routes P1 and P2
# ---------------------------------------------------------------------------

ROUTES = {
    "P1": dict(r_hat=1e-4, fused="kernel"),
    "P2": dict(r_hat=1e-4, use_pallas=True),
    "P2_ideal": dict(r_hat=0.0, use_pallas=True),
}


@pytest.fixture(scope="module")
def lm():
    j_params = jax.tree.map(jnp.asarray, _np_tree(NPZ))
    t_params = interop.load_params_npz(NPZ, device="cpu")
    rng = np.random.default_rng(0)
    calib = rng.integers(0, 128, size=(4, 16)).astype(np.int32)
    prompts = rng.integers(0, 128, size=(3, 7)).astype(np.int32)
    return j_smoke("qwen1.5-4b"), t_smoke("qwen1.5-4b"), j_params, t_params, \
        calib, prompts


_PACKS = {}


def _route_packs(lm, route):
    """The reference pack of ``route`` (programmed, calibrated compiled) and
    its port copy under the port's spec; P1's reference runs its fused
    oracle (its Pallas kernel computes the same function bit for bit)."""
    if route not in _PACKS:
        j_cfg, t_cfg, j_params, _, calib, _ = lm
        kw = dict(ROUTES[route])
        t_spec = TA.design_a(error=TE.state_proportional(0.05), **kw)
        if kw.get("fused") == "kernel":
            kw["fused"] = "oracle"
        j_spec = JA.design_a(error=JE.state_proportional(0.05), **kw)
        j_pack = j_program(j_cfg, j_params, j_spec, jax.random.PRNGKey(7))
        j_pack = jax.jit(lambda p, pk, c: j_calibrate(j_cfg, p, pk, c))(
            j_params, j_pack, jnp.asarray(calib))
        t_pack = interop.pack_from_numpy(_export_pack(j_pack), t_spec, t_cfg,
                                         device="cpu")
        _PACKS[route] = (j_pack, t_pack)
    return _PACKS[route]


def _record_flips(monkeypatch, seq_len):
    """Hold every analog site of the port's forward against the reference
    on the port's operands (the fused parasitic chain, the legacy kernels'
    oracles) under its kernel's bound, noting the ``(batch row,
    position)`` of each allowed one-code ADC flip; and collect each site's
    activations and clip.  Returns ``(flips, inputs)``."""
    from repro_torch.core import analog as t_analog

    flips, inputs = [], []

    def note(y, y_ref, scale):
        y_ref = np.asarray(y_ref)
        d = np.abs(y.numpy() - y_ref)
        tight = (d <= 2 * np.spacing(np.maximum(np.abs(y_ref), np.abs(
            y.numpy())))) | (d <= 0.25 * float(scale))
        for row in np.nonzero(~tight.all(axis=1))[0]:
            flips.append(divmod(int(row), seq_len))

    fused = t_ref.fused_mvm_parasitic

    def fused_rec(x, gp, gm, r_hat, lo, hi, scale, **kw):
        y = fused(x, gp, gm, r_hat, lo, hi, scale, **kw)
        y_ref = j_ref.fused_mvm_parasitic(
            *(jnp.asarray(t.numpy()) for t in (x, gp, gm)), r_hat,
            jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
            jnp.asarray(scale.numpy()), bm=x.shape[0], bn=gp.shape[-1], **kw)
        res = tolerance.fused_mvm_parasitic_check(
            torch.as_tensor(np.array(y_ref)), y, x, gp, gm, r_hat, lo, hi,
            scale, **kw)
        assert res["ok"], res
        note(y, y_ref, scale)
        return y

    legacy_par = t_ref.analog_mvm_parasitic_diff
    legacy = t_ref.analog_mvm_diff

    def legacy_rec(x, gp, gm, **kw):
        y = (legacy_par if "r_hat" in kw else legacy)(x, gp, gm, **kw)
        j_fn = (j_ref.analog_mvm_parasitic_diff if "r_hat" in kw
                else j_ref.analog_mvm_diff)
        jkw = dict(kw, adc_lo=jnp.asarray(kw["adc_lo"].numpy()),
                   adc_hi=jnp.asarray(kw["adc_hi"].numpy()))
        y_ref = j_fn(*(jnp.asarray(t.numpy()) for t in (x, gp, gm)), **jkw)
        res = tolerance.analog_mvm_check(
            torch.as_tensor(np.array(y_ref)), y, x, gp, gm, kw["adc_lo"],
            kw["adc_hi"], kw["gain"], adc_bits=kw["adc_bits"],
            r_hat=kw.get("r_hat"), n_bits=kw.get("n_bits"))
        assert res["ok"], res
        note(y, y_ref, kw["gain"])
        return y

    def matmul_rec(x, aw, spec, **kw):
        inputs.append((x.float().numpy(), kw["act_hi"].numpy()))
        return matmul(x, aw, spec, **kw)

    matmul = t_analog.analog_matmul
    monkeypatch.setattr(t_ref, "fused_mvm_parasitic", fused_rec)
    monkeypatch.setattr(t_ref, "analog_mvm_parasitic_diff", legacy_rec)
    monkeypatch.setattr(t_ref, "analog_mvm_diff", legacy_rec)
    monkeypatch.setattr("repro_torch.models.layers.analog_matmul", matmul_rec)
    monkeypatch.setattr("repro_torch.models.transformer.analog_matmul",
                        matmul_rec)
    return flips, inputs


def _reference_site_inputs(monkeypatch):
    """Collect, in call order, each analog site's activations and clip in
    the reference's compiled forward (a host callback from inside its
    layer scan)."""
    inputs = []
    matmul = JA.analog_matmul

    def matmul_rec(x, aw, spec, **kw):
        jax.debug.callback(
            lambda a, h: inputs.append((np.asarray(a), np.asarray(h))),
            x, kw["act_hi"], ordered=True)
        return matmul(x, aw, spec, **kw)

    monkeypatch.setattr("repro.models.layers.analog_matmul", matmul_rec)
    monkeypatch.setattr("repro.models.transformer.analog_matmul", matmul_rec)
    return inputs


def _quantizer_flips(t_inputs, j_inputs, input_bits, seq_len):
    """``(batch row, position)`` where a site's activation quantizes to a
    different integer on the two sides.  The sides' activations differ by
    float rounding upstream (the reference's compiled forward rounds some
    site outputs an ulp away from its own op-by-op evaluation, which the
    port equals); where one lands on either side of a rounding edge, the
    codes differ by one and everything downstream of that position moves.
    Each such element is checked to be exactly that: codes one apart, and
    activations within 1e-5 of the site's activation scale (the tolerance
    of the digital logits in ``tests/test_torch_model.py``), at positions
    not already downstream of an earlier flip."""
    assert len(t_inputs) == len(j_inputs)
    flips = set()
    for (xt, ht), (xj, hj) in zip(t_inputs, j_inputs):
        assert xt.shape == xj.shape and ht == hj
        k = xt.shape[-1]
        qt, qj = (t_quant.quantize_acts(
            torch.as_tensor(np.array(a).reshape(-1, k)), input_bits,
            clip_hi=torch.as_tensor(ht)).values.numpy() for a in (xt, xj))
        for row, col in np.argwhere(qt != qj):
            pos = divmod(int(row), seq_len)
            if any(b == pos[0] and t <= pos[1] for b, t in flips):
                continue
            assert abs(qt[row, col] - qj[row, col]) == 1
            scale = np.abs(xt.reshape(-1, k)).max()
            assert abs(xt.reshape(-1, k)[row, col]
                       - xj.reshape(-1, k)[row, col]) <= 1e-5 * scale
            flips.add(pos)
    return sorted(flips)


@pytest.mark.parametrize("route", list(ROUTES))
def test_slice_logits_within_bound(lm, route, monkeypatch):
    """Logits within 2 ulp or 0.25 of the head's dequant grid step, except
    at positions at or after a site's allowed one-code ADC flip or an
    activation that the two sides quantize to neighbouring integers
    (``tests/test_torch_model.py``'s rule, with the quantizer cases read
    from both sides' activations)."""
    j_cfg, t_cfg, j_params, t_params, calib, _ = lm
    j_pack, t_pack = _route_packs(lm, route)
    with monkeypatch.context() as mp:
        j_inputs = _reference_site_inputs(mp)
        lg_j = np.asarray(JT.forward(j_cfg, j_params, jnp.asarray(calib),
                                     pack=j_pack, remat=False)[0])
    flips, t_inputs = _record_flips(monkeypatch, calib.shape[1])
    lg_t = TT.forward(t_cfg, t_params, torch.as_tensor(calib),
                      pack=t_pack)[0].numpy()
    flips += _quantizer_flips(t_inputs, j_inputs,
                              t_pack.head_spec.input_bits, calib.shape[1])
    d = np.abs(lg_t - lg_j)
    mag = np.maximum(np.abs(lg_t), np.abs(lg_j))
    ok = (d <= 2 * np.spacing(mag.astype(np.float32))) \
        | (d <= 0.25 * _head_grid(t_pack))
    for b, t in flips:
        ok[b, t:] = True
    assert len(flips) <= calib.size // 8, flips
    assert ok.all(), (f"{int((~ok).sum())} of {ok.size} logits outside the "
                      f"bound, max diff {d[~ok].max():.3e}; reference-"
                      f"rounding flips at {sorted(set(flips))}")


@pytest.mark.parametrize("route", list(ROUTES))
def test_slice_greedy_tokens_match_up_to_near_ties(lm, route):
    j_cfg, t_cfg, j_params, t_params, _, prompts = lm
    j_pack, t_pack = _route_packs(lm, route)
    n_new = 6
    tok_j = np.asarray(j_decode(j_cfg, j_params, jnp.asarray(prompts), n_new,
                                pack=j_pack))
    tok_t = t_decode(t_cfg, t_params, torch.as_tensor(prompts), n_new,
                     pack=t_pack).numpy()
    for row in range(prompts.shape[0]):
        diff = np.nonzero(tok_t[row] != tok_j[row])[0]
        if diff.size == 0:
            continue
        i = int(diff[0])
        seq = np.concatenate([prompts[row], tok_j[row, :i]])[None]
        lg = np.asarray(JT.forward(j_cfg, j_params, jnp.asarray(seq),
                                   pack=j_pack, remat=False)[0])[0, -1]
        top2 = np.sort(lg)[-2:]
        assert top2[1] - top2[0] < 1e-4 * np.abs(lg).max(), (
            f"row {row} leaves the reference at step {i} away from a near tie")


@pytest.mark.parametrize("route", list(ROUTES))
def test_slice_runtime_matches_decode_lm(lm, route):
    """The port's ServeRuntime equals its decode_lm at 1.0 on the route's
    pack, and the wrappers the route needs are the ones that ran."""
    _, t_cfg, _, t_params, _, _ = lm
    _, t_pack = _route_packs(lm, route)
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, 128, size=int(n)).astype(np.int32), int(m))
            for n, m in ((4, 5), (9, 3), (6, 6), (3, 4))]
    rt = ServeRuntime(t_cfg, t_params, pack=t_pack, max_slots=3, max_len=20)
    uids = [rt.submit(p, max_new_tokens=m) for p, m in reqs]
    outs = rt.run()
    agree = total = 0
    for (p, m), uid in zip(reqs, uids):
        ref = t_decode(t_cfg, t_params, torch.as_tensor(p)[None], m,
                       pack=t_pack)[0].numpy()
        assert outs[uid].shape == (m,)
        agree += int((outs[uid] == ref).sum())
        total += m
    assert agree / total == 1.0


def _mixed_profiles():
    """The same heterogeneous profile in both packages: Design A on the
    attention sites, route P2 (use_pallas, parasitic) on w_up, route P1 on
    w_down's first layer band and Design A on its second, the rest and
    the head on route P1."""
    out = []
    for mod, hw in ((JA, "repro.hw"), (TA, "repro_torch.hw")):
        hwm = __import__(hw, fromlist=["Profile", "Rule"])
        base = mod.design_a(fused="kernel")
        p1 = dataclasses.replace(base, r_hat=1e-4)
        p2 = dataclasses.replace(base, r_hat=1e-4, use_pallas=True,
                                 fused="off")
        out.append(hwm.Profile(rules=(
            hwm.Rule("attn.*", base),
            hwm.Rule("w_up", p2),
            hwm.Rule("w_down", p1, layers=(0, 1)),
            hwm.Rule("w_down", base, layers=(1, 2)),
        ), default=p1))
    return out


def test_mixed_profile_site_classes_match():
    from repro.hw import fused_site_classes as j_classes
    from repro_torch.hw import fused_site_classes as t_classes

    j_prof, t_prof = _mixed_profiles()
    sites = ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "head"]
    assert t_classes(t_prof, sites, 2) == j_classes(j_prof, sites, 2)
    assert ("parasitic", 1, 7, 8, None, 7) in t_classes(t_prof, sites, 2)


def test_mixed_profile_rides_program_calibrate_serve(lm, monkeypatch):
    """A Profile mixing Design A, route P1 and route P2 by site and layer
    band rides through program_lm -> calibrate_lm -> ServeRuntime as a
    global spec does: the runtime equals decode_lm at 1.0, and each
    route's plain version ran."""
    from repro_torch.serve import calibrate_lm, program_lm

    _, t_cfg, _, t_params, calib, _ = lm
    _, t_prof = _mixed_profiles()
    pack = program_lm(t_cfg, t_params, t_prof, seed=3)
    assert pack.site_spec("w_up").use_pallas
    assert pack.head_spec.parasitics_on
    calls = {}
    for name in ("fused_mvm_diff", "fused_mvm_parasitic",
                 "analog_mvm_parasitic_diff", "bitline_mvm"):
        def counting(*a, _p=getattr(t_ref, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _p(*a, **k)

        monkeypatch.setattr(t_ref, name, counting)
    pack = calibrate_lm(t_cfg, t_params, pack, torch.as_tensor(calib))
    assert calls.get("bitline_mvm", 0) > 0
    reqs = [(np.arange(3 + i, dtype=np.int32) * 7 % 128, 4) for i in range(3)]
    rt = ServeRuntime(t_cfg, t_params, pack=pack, max_slots=2, max_len=16)
    uids = [rt.submit(p, max_new_tokens=m) for p, m in reqs]
    outs = rt.run()
    for (p, m), uid in zip(reqs, uids):
        ref = t_decode(t_cfg, t_params, torch.as_tensor(p)[None], m,
                       pack=pack)[0].numpy()
        np.testing.assert_array_equal(outs[uid], ref)
    for name in ("fused_mvm_diff", "fused_mvm_parasitic",
                 "analog_mvm_parasitic_diff"):
        assert calls.get(name, 0) > 0, (name, calls)
