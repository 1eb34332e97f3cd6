"""The port's sweep engine (``repro_torch.sweep``), energy model
(``core.energy``), mapping helpers and ``analog_eval_loss`` against the
JAX package, on the CPU.

* **Grids.**  The ten benchmark grids are built through the reference's
  ``benchmarks`` modules and converted to the port's dataclasses by class
  and field name (:func:`to_port`); expansion (tags, coords, indices),
  protocols, dynamic fields and the compile-group partition must equal
  the reference's.
* **Cache.**  The reference's ``tests/test_sweep.py`` cache contracts,
  on the port's engine; a port signature never equals the reference's.
* **Executor ≡ serial** in the port, to the bit, ADC or not: the port
  loops over a group's points with each point's own values, so nothing
  is batched that could move an ADC edge.
* **Classifier vs reference** on the trained MLP (``benchmarks.common``,
  trained into a private directory), ``test_n`` 512: deterministic points
  (alpha 0) within 2 samples; noisy points within 2 samples per trial on
  the reference's programmed conductances, injected; fig9's a0.05 means
  within 3 combined standard errors over 16 trials of each package's own
  draws; the paper's differential >= offset claim on the port's fig8 and
  fig9 grids.
* **ServeEvaluator vs reference** on the trained smoke LM: with the
  reference's programmed pack injected, loss within rtol 1e-4, top1 and
  decode_match within the reference's own executor-vs-serial bounds
  (``tests/test_serve_sweep.py``: 4 flipped tokens, one diverged
  continuation); in the port ``run_sweep`` equals
  ``serve_serial_reference``, on a hetero profile grid and a drift grid
  too; lm_accuracy's claim (proportional < offset at 8b a0.05, 3 trials).
* **core leftovers**: ``energy`` equal (``==``) to the reference's; the
  mapping helpers integer-exact (``average_conductance``, the float64 mean
  rounded once, within 1 ulp of the reference beyond the reference's own
  float32 summation error); the reference's hypothesis properties on the
  port; ``analog_eval_loss``.
"""

import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import repro.sweep as J
from repro.core import analog as JA
from repro.core import energy as JEN
from repro.core import mapping as JM
from repro.core.adc import ADCConfig as JADC
from repro.core.errors import power_law_drift as j_drift
from repro.core.errors import state_independent as j_ind
from repro.core.errors import state_proportional as j_prop
from repro.hw import profile as JP
from repro.serve import analog_engine as JAE
from repro_torch import interop
from repro_torch import sweep as T
from repro_torch.configs import get_smoke_config
from repro_torch.core import adc as TADC
from repro_torch.core import analog as TA
from repro_torch.core import energy as TEN
from repro_torch.core import errors as TE
from repro_torch.core import mapping as TM
from repro_torch.hw import profile as TP
from repro_torch.serve import analog_engine as TAE
from repro_torch.sweep import evaluate as t_evaluate
from repro_torch.sweep import serve_eval as t_serve_eval
from repro_torch.sweep import spec as t_spec
from test_torch_model import NPZ, _export_pack

DEV = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's ops here are small, so one intra-op thread runs them
    fastest, and several pytest-xdist workers sharing the cores do not
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# reference dataclass -> port dataclass
# ---------------------------------------------------------------------------

PORT_CLASSES = {c.__name__: c for c in (
    TA.AnalogSpec, TM.MappingConfig, TADC.ADCConfig, TE.ErrorModel,
    TE.DriftModel, TE.FaultModel, TP.Profile, TP.Rule, t_spec.SweepSpec,
    t_spec.Axis)}


def to_port(v):
    """A reference value rebuilt from the port's dataclasses, by class and
    field name (a field the port lacks raises)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        cls = PORT_CLASSES[type(v).__name__]
        return cls(**{f.name: to_port(getattr(v, f.name))
                      for f in dataclasses.fields(v) if f.init})
    if isinstance(v, tuple):
        return tuple(to_port(x) for x in v)
    if isinstance(v, list):
        return [to_port(x) for x in v]
    if isinstance(v, type):                      # compute_dtype
        return getattr(torch, np.dtype(v).name)
    return v


class _Dyn:
    """The accuracy evaluators' grouping protocol alone."""

    def __init__(self, fields):
        self.dynamic_fields = fields


def _ref_grids():
    """``{name: (reference SweepSpec, grouped by the accuracy evaluators'
    dynamic fields?)}`` of the ten benchmark grids."""
    from benchmarks.driftbench import drift_sweep
    from benchmarks.fig8_9_cell_errors import ALPHAS_IND, ALPHAS_PROP, fig_sweep
    from benchmarks.fig15_16_adc import fig15_sweep, fig16_sweep
    from benchmarks.fig19_parasitics import fig19_sweep
    from benchmarks.hetero_precision import hetero_sweep
    from benchmarks.lm_accuracy import lm_parasitics_sweep, lm_sweep
    from benchmarks.table3_energy import DESIGNS, spec_of

    table3 = J.SweepSpec.from_points(
        "table3", [(name, spec_of(s, b, r, a))
                   for name, s, b, r, a, _, _, _ in DESIGNS], trials=0)
    return {
        "fig8": (fig_sweep("fig8", j_ind, ALPHAS_IND), True),
        "fig9": (fig_sweep("fig9", j_prop, ALPHAS_PROP), True),
        "fig15": (fig15_sweep(), True),
        "fig16": (fig16_sweep(), True),
        "fig19": (fig19_sweep(), True),
        "hetero": (hetero_sweep(), True),
        "drift": (drift_sweep(), True),
        "lm_accuracy": (lm_sweep(), True),
        "lm_parasitics": (lm_parasitics_sweep(), True),
        "table3": (table3, False),
    }


GRID_NAMES = ("fig8", "fig9", "fig15", "fig16", "fig19", "hetero", "drift",
              "lm_accuracy", "lm_parasitics", "table3")


@pytest.fixture(scope="module")
def ref_grids():
    return _ref_grids()


def _partition(groups):
    return [[pt.index for _, pt, _ in members]
            for _, _, members in groups]


@pytest.mark.parametrize("name", GRID_NAMES)
def test_grid_parity(ref_grids, name):
    """Expansion, protocol, dynamic fields and compile groups of a
    benchmark grid equal the reference's."""
    j_sweep, accuracy = ref_grids[name]
    t_sweep = to_port(j_sweep)
    jp, tp = j_sweep.expand(), t_sweep.expand()
    assert [p.tag for p in tp] == [p.tag for p in jp]
    assert [p.index for p in tp] == [p.index for p in jp]
    assert [p.coords for p in tp] == [to_port(p.coords) for p in jp]
    assert [p.spec for p in tp] == [to_port(p.spec) for p in jp]
    assert t_sweep.point_protocol() == j_sweep.point_protocol()
    if accuracy:
        assert [T.evaluate.dynamic_fields_for(p.spec) for p in tp] == \
            [J.evaluate.dynamic_fields_for(p.spec) for p in jp]
        j_ev = _Dyn(J.evaluate.dynamic_fields_for)
        t_ev = _Dyn(T.evaluate.dynamic_fields_for)
    else:
        j_ev = J.FunctionEvaluator(lambda s: 0.0, name="t")
        t_ev = T.FunctionEvaluator(lambda s: 0.0, name="t")
    jg = J.compile_groups([(str(p.index), p) for p in jp], j_ev,
                          all_points=jp)
    tg = T.compile_groups([(str(p.index), p) for p in tp], t_ev,
                          all_points=tp)
    assert _partition(tg) == _partition(jg)
    assert [names for _, names, _ in tg] == [names for _, names, _ in jg]
    assert [[row for _, _, row in m] for _, _, m in tg] == \
        [[row for _, _, row in m] for _, _, m in jg]
    assert [t for t, _, _ in tg] == [to_port(t) for t, _, _ in jg]


def test_grid_group_counts(ref_grids):
    """The groups the paper's figures rely on: the Fig. 19 and
    lm_parasitics r_hat axes are one group a scheme, lm_accuracy one group
    a (scheme, bits) cell."""
    counts = {}
    for name in ("fig19", "lm_parasitics", "lm_accuracy", "drift"):
        pts = to_port(ref_grids[name][0]).expand()
        counts[name] = len(T.compile_groups(
            [(str(p.index), p) for p in pts],
            _Dyn(T.evaluate.dynamic_fields_for), all_points=pts))
    assert counts == {"fig19": 2, "lm_parasitics": 1, "lm_accuracy": 4,
                      "drift": 1}


def test_sweep_exports_reference_names():
    assert T.__all__ == J.__all__


@pytest.mark.parametrize("path,value,j_value", [
    ("mapping.scheme", "offset", "offset"),
    ("adc.bits", 6, 6),
    ("error.alpha", 0.07, 0.07),
    ("drift.t", 64.0, 64.0),
    ("r_hat", 1e-4, 1e-4),
    ("error", TE.state_independent(0.02), j_ind(0.02)),
])
def test_set_get_field_roundtrip(path, value, j_value):
    base = TA.design_a(error=TE.state_proportional(0.05),
                       drift=TE.power_law_drift(0.2))
    spec = T.set_field(base, path, value)
    assert T.get_field(spec, path) == value
    assert T.get_field(base, path) != value
    j_base = JA.design_a(error=j_prop(0.05), drift=j_drift(0.2))
    assert spec == to_port(J.set_field(j_base, path, j_value))
    assert base == to_port(j_base)


def _profiles():
    j_spec = JA.design_a(error=j_prop(0.05))
    j_prof = JP.Profile(rules=(
        JP.Rule("attn.*", j_spec, layers=(0, 1), name="attn"),
        JP.Rule("attn.*", j_spec, layers=(1, 4), name="attn"),
        JP.Rule("mlp.*", j_spec, name="mlp"),
        JP.Rule("head", JP.DIGITAL, name="head"),
    ), default=JP.DIGITAL)
    return j_prof, to_port(j_prof)


@pytest.mark.parametrize("selector,path,value", [
    ("attn", "adc.bits", 6),
    ("mlp", "error.alpha", 0.1),
    ("attn", "mapping.on_off_ratio", 100.0),
    ("head", "adc.bits", 6),          # a DIGITAL rule
    ("default", "adc.bits", 6),       # a DIGITAL default
    ("nope", "adc.bits", 6),          # no such selector
])
def test_profile_with_field_matches_reference(selector, path, value):
    j_prof, t_prof = _profiles()

    def run(prof):
        try:
            out = prof.with_field(selector, path, value)
            return "ok", out, out.field(selector, path)
        except ValueError as e:
            return "error", str(e), None

    j_out, t_out = run(j_prof), run(t_prof)
    assert t_out[0] == j_out[0]
    if t_out[0] == "ok":
        assert t_out[1] == to_port(j_out[1])
        assert t_out[2] == j_out[2] == value
        # every rule the selector targets was set (both attn bands)
        assert [r.spec for r in t_out[1].rules] == \
            [to_port(r.spec) for r in j_out[1].rules]
    else:
        assert t_out[1] == j_out[1]
    for bad in ("attn.adc.bits", ":adc.bits", "attn:"):
        with pytest.raises(ValueError) as te:
            T.set_field(t_prof, bad, 6)
        with pytest.raises(ValueError) as je:
            J.set_field(j_prof, bad, 6)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        t_prof.field("head", "adc.bits")
    with pytest.raises(ValueError) as je:
        j_prof.field("head", "adc.bits")
    assert str(te.value) == str(je.value)


def test_dispatch_is_single_device():
    """Without a process group nothing is split: the mesh is None and the
    placement helpers hand their inputs back (the gloo mesh's split is
    held in tests/test_torch_distribution.py)."""
    from repro_torch.sweep import dispatch as TD

    assert T.sweep_mesh() is None
    x = torch.zeros(4)
    assert T.shard_leading(x, None) is x
    rows, seeds = [(0.1,), (0.2,)], [1, 2, 3]
    assert TD.shard_point_trial_batch(rows, seeds, None) == (rows, seeds,
                                                             None)
    block = [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]
    assert TD.gather_point_trial(block, None, None) is block
    res = T.run_sweep(T.SweepSpec(name="m", trials=2),
                      T.FunctionEvaluator(lambda s: 1.0, name="m"),
                      mesh=T.sweep_mesh())
    assert [r.values for r in res] == [[1.0]]


# ---------------------------------------------------------------------------
# the tiny vehicle of tests/test_sweep.py, exported to numpy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vehicle():
    ks = jax.random.split(jax.random.PRNGKey(0), 6)
    dims = (16, 32, 8)
    layers = [
        (np.asarray(jax.random.normal(ks[i], (dims[i], dims[i + 1]))
                    * dims[i] ** -0.5), np.zeros((dims[i + 1],), np.float32))
        for i in range(2)
    ]
    xca = np.asarray(jax.random.normal(ks[3], (64, 16)))
    xte = np.asarray(jax.random.normal(ks[4], (128, 16)))
    yte = np.asarray(jax.random.randint(ks[5], (128,), 0, 8))
    return layers, xca, xte, yte


def _t_ev(vehicle, **kw):
    return T.ClassifierEvaluator(*vehicle, device=DEV, **kw)


def _t_layers(vehicle):
    layers, xca, xte, yte = vehicle
    return ([(torch.tensor(w), torch.tensor(b)) for w, b in layers],
            torch.tensor(xca), torch.tensor(xte), torch.tensor(yte))


class _Counting:
    """Delegates to a real evaluator, counting group evaluations."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def signature(self):
        return self.inner.signature()

    def dynamic_fields(self, spec):
        return self.inner.dynamic_fields(spec)

    def evaluate_group(self, *a, **kw):
        self.calls += 1
        return self.inner.evaluate_group(*a, **kw)


def _cache_sweep():
    return T.SweepSpec(
        name="cache_t",
        base=TA.AnalogSpec(adc=TADC.ADCConfig(style="none"),
                           error=TE.state_proportional(0.0)),
        axes=(T.Axis("error.alpha", (0.02, 0.1)),),
        trials=2,
    )


def test_resume_from_cache(vehicle, tmp_path):
    ev = _Counting(_t_ev(vehicle))
    res1 = T.run_sweep(_cache_sweep(), ev, cache_dir=str(tmp_path))
    assert ev.calls == 1 and res1.n_cached == 0
    assert (tmp_path / "sweeps" / "cache_t.json").exists()
    res2 = T.run_sweep(_cache_sweep(), ev, cache_dir=str(tmp_path))
    assert ev.calls == 1 and res2.n_cached == 2
    for r1, r2 in zip(res1, res2):
        assert (r1.values, r1.tag) == (r2.values, r2.tag)
    wider = dataclasses.replace(
        _cache_sweep(), axes=(T.Axis("error.alpha", (0.02, 0.1, 0.2)),))
    res3 = T.run_sweep(wider, ev, cache_dir=str(tmp_path))
    assert ev.calls == 2 and res3.n_cached == 2 and len(res3) == 3
    res4 = T.run_sweep(_cache_sweep(), ev, cache_dir=str(tmp_path),
                       force=True)
    assert ev.calls == 3
    for r1, r4 in zip(res1, res4):
        assert r1.values == r4.values
    assert all(r.wall_s > 0 for r in res4)


def test_cache_misses_on_evaluator_signature_change(vehicle, tmp_path):
    ev1 = _Counting(_t_ev(vehicle, version="v1"))
    T.run_sweep(_cache_sweep(), ev1, cache_dir=str(tmp_path))
    ev2 = _Counting(_t_ev(vehicle, version="v2"))
    res = T.run_sweep(_cache_sweep(), ev2, cache_dir=str(tmp_path))
    assert ev2.calls == 1 and res.n_cached == 0


def test_cache_misses_on_spec_change(vehicle, tmp_path):
    ev = _Counting(_t_ev(vehicle))
    T.run_sweep(_cache_sweep(), ev, cache_dir=str(tmp_path))
    changed = dataclasses.replace(
        _cache_sweep(),
        base=dataclasses.replace(_cache_sweep().base, input_bits=7))
    res = T.run_sweep(changed, ev, cache_dir=str(tmp_path))
    assert ev.calls == 2 and res.n_cached == 0


def test_cache_misses_on_trial_protocol_change(vehicle, tmp_path):
    ev = _Counting(_t_ev(vehicle))
    T.run_sweep(_cache_sweep(), ev, cache_dir=str(tmp_path))
    calls = ev.calls
    for change in (dict(trials=3), dict(seed=99), dict(test_n=32)):
        res = T.run_sweep(dataclasses.replace(_cache_sweep(), **change), ev,
                          cache_dir=str(tmp_path))
        calls += 1
        assert ev.calls == calls, f"{change} must miss the cache"
        assert res.n_cached == 0


def test_cache_hits_on_axis_reordering(vehicle, tmp_path):
    ab = T.SweepSpec(
        name="reorder_t",
        base=TA.AnalogSpec(adc=TADC.ADCConfig(style="none"),
                           error=TE.state_proportional(0.0)),
        axes=(T.Axis("error.alpha", (0.02, 0.1)),
              T.Axis("max_rows", (72, 1152))),
        trials=1,
    )
    ba = dataclasses.replace(ab, axes=tuple(reversed(ab.axes)))
    ev = _Counting(_t_ev(vehicle))
    res1 = T.run_sweep(ab, ev, cache_dir=str(tmp_path))
    calls = ev.calls
    res2 = T.run_sweep(ba, ev, cache_dir=str(tmp_path))
    assert ev.calls == calls and res2.n_cached == len(res2) == 4
    by1 = {repr(ab.expand()[r.index].spec): r.values for r in res1}
    by2 = {repr(ba.expand()[r.index].spec): r.values for r in res2}
    assert by1 == by2


def test_corrupt_cache_recomputes_cleanly(vehicle, tmp_path):
    ev = _Counting(_t_ev(vehicle))
    res1 = T.run_sweep(_cache_sweep(), ev, cache_dir=str(tmp_path))
    path = tmp_path / "sweeps" / "cache_t.json"
    path.write_text(path.read_text()[:40])
    res2 = T.run_sweep(_cache_sweep(), ev, cache_dir=str(tmp_path))
    assert ev.calls == 2 and res2.n_cached == 0
    assert [r.values for r in res2] == [r.values for r in res1]
    res3 = T.run_sweep(_cache_sweep(), ev, cache_dir=str(tmp_path))
    assert ev.calls == 2 and res3.n_cached == 2


def test_port_signatures_never_equal_reference(vehicle):
    layers, xca, xte, yte = vehicle
    j_ev = J.ClassifierEvaluator([(jnp.asarray(w), jnp.asarray(b))
                                  for w, b in layers], xca, xte, yte)
    t_ev = _t_ev(vehicle)
    assert t_ev.signature() != j_ev.signature()
    assert t_ev.signature().startswith("classifier/torch-v1/relu/")
    sweep = _cache_sweep()
    pt = sweep.expand()[0]
    j_pt = J.SweepSpec(
        name="cache_t", base=JA.AnalogSpec(adc=JADC(style="none"),
                                           error=j_prop(0.0)),
        axes=(J.Axis("error.alpha", (0.02, 0.1)),), trials=2).expand()[0]
    assert T.point_key(t_ev.signature(), pt, sweep.point_protocol()) != \
        J.point_key(j_ev.signature(), j_pt, sweep.point_protocol())
    f_t = T.FunctionEvaluator(lambda s: 0.0, name="f", data=(xca,))
    f_j = J.FunctionEvaluator(lambda s: 0.0, name="f", data=(xca,))
    assert f_t.signature() != f_j.signature()
    assert f_t.signature().startswith("function/f/torch-v1/")


def test_function_evaluator_per_trial_seeds(tmp_path):
    seen = []

    def probe(spec, seed):
        seen.append(seed)
        return torch.tensor(spec.mapping.g_min)

    sweep = T.SweepSpec(
        name="fn_t", base=TA.AnalogSpec(),
        axes=(T.Axis("mapping.on_off_ratio", (10.0, 100.0)),), trials=3)
    ev = T.FunctionEvaluator(probe, name="probe", takes_key=True)
    res = T.run_sweep(sweep, ev, cache_dir=str(tmp_path))
    assert res["on_off_ratio10"].values == pytest.approx([0.1] * 3)
    assert res["on_off_ratio100"].values == pytest.approx([0.01] * 3)
    assert seen == T.trial_keys(1234, 3) * 2
    res2 = T.run_sweep(sweep, ev, cache_dir=str(tmp_path))
    assert res2.n_cached == 2
    assert res2["on_off_ratio10"].values == res["on_off_ratio10"].values


# ---------------------------------------------------------------------------
# executor == serial, in the port
# ---------------------------------------------------------------------------

EXECUTOR_GRIDS = {
    "no_adc": T.SweepSpec(
        name="t", base=TA.AnalogSpec(
            mapping=TM.MappingConfig(scheme="differential"),
            adc=TADC.ADCConfig(style="none"),
            error=TE.state_proportional(0.0), input_accum="analog"),
        axes=(T.Axis("error.alpha", (0.02, 0.1)),
              T.Axis("mapping.on_off_ratio", (100.0, float("inf")))),
        trials=3, seed=7),
    "r_hat": T.SweepSpec(
        name="t", base=TA.AnalogSpec(
            mapping=TM.MappingConfig(scheme="differential", on_off_ratio=1e4),
            adc=TADC.ADCConfig(style="none"),
            error=TE.state_proportional(0.02), input_accum="analog",
            max_rows=64),
        axes=(T.Axis("r_hat", (1e-5, 1e-4, 1e-3)),), trials=2, seed=7),
    "calibrated_adc": T.SweepSpec(
        name="t", base=TA.AnalogSpec(
            mapping=TM.MappingConfig(scheme="offset", bits_per_cell=2,
                                     on_off_ratio=1e4),
            adc=TADC.ADCConfig(style="calibrated", bits=8),
            error=TE.state_independent(0.0), input_accum="digital",
            max_rows=72),
        axes=(T.Axis("error.alpha", (0.01, 0.05)),), trials=2, seed=7),
}


@pytest.mark.parametrize("grid", sorted(EXECUTOR_GRIDS))
def test_executor_matches_serial_bitexact(vehicle, grid):
    sweep = EXECUTOR_GRIDS[grid]
    res = T.run_sweep(sweep, _t_ev(vehicle))
    pts = sweep.expand()
    layers, xca, xte, yte = _t_layers(vehicle)
    assert len(res) == len(pts)
    for r in res:
        _, _, accs = T.serial_accuracy(layers, pts[r.index].spec, xca, xte,
                                       yte, trials=sweep.trials,
                                       seed=sweep.seed)
        assert r.values == accs, r.tag


def test_program_split_is_identity(vehicle):
    w = torch.tensor(vehicle[0][0][0])
    spec = TA.AnalogSpec(
        mapping=TM.MappingConfig(scheme="differential", bits_per_cell=2,
                                 on_off_ratio=1e3),
        error=TE.state_proportional(0.05))
    direct = TA.program(w, spec, 3)
    split = TA.program_from_codes(TA.program_codes(w, spec), spec, 3)
    assert torch.equal(direct.g_pos, split.g_pos)
    assert torch.equal(direct.g_neg, split.g_neg)


# ---------------------------------------------------------------------------
# the classifier against the reference, on the trained MLP
# ---------------------------------------------------------------------------

TEST_N = 512
STAT_TRIALS = 16


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    """The reference's trained MLP and eval splits, trained into a private
    directory (another test process may be writing the shared cache)."""
    import benchmarks.common as C

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C, "CACHE", str(tmp_path_factory.mktemp("mlp_cache")))
        params = C.train_mlp()
    xca, _, xte, yte = C.eval_data()
    np_layers = [(np.asarray(w), np.asarray(b)) for w, b in params]
    j_ev = J.ClassifierEvaluator(params, xca, xte, yte)
    t_ev = T.ClassifierEvaluator(np_layers, np.asarray(xca), np.asarray(xte),
                                 np.asarray(yte), device=DEV)
    return params, j_ev, t_ev


def _det_sweep():
    from benchmarks.fig8_9_cell_errors import SCHEME_AXIS

    return J.SweepSpec(
        name="det",
        base=JA.AnalogSpec(mapping=JM.MappingConfig(on_off_ratio=1e4),
                           error=j_prop(0.0), max_rows=1152),
        axes=(SCHEME_AXIS,
              J.Axis("mapping.bits_per_cell", (None, 2),
                     labels=("bpcNone", "bpc2")),
              J.Axis("adc", (JADC(style="none"),
                             JADC(style="calibrated", bits=8)),
                     labels=("noadc", "adc8"))),
        trials=1, test_n=TEST_N)


#: the deterministic points held (scheme x slicing x ADC, one ADC-free)
DET_TAGS = ("differential_bpcNone_noadc", "differential_bpcNone_adc8",
            "differential_bpc2_adc8", "offset_bpc2_adc8")


def test_classifier_deterministic_points_match_reference(mlp):
    """alpha 0 leaves programming deterministic: the packages differ only
    where a value sits on an ADC or quantizer edge."""
    _, j_ev, t_ev = mlp
    full = _det_sweep()
    pts = [p for p in full.expand() if p.tag in DET_TAGS]
    j_sweep = J.SweepSpec.from_points(
        "det", [(p.tag, p.spec) for p in pts], trials=1, test_n=TEST_N)
    j_res = J.run_sweep(j_sweep, j_ev)
    t_res = T.run_sweep(to_port(j_sweep), t_ev)
    for tag in DET_TAGS:
        assert abs(t_res[tag].values[0] - j_res[tag].values[0]) \
            <= 2 / TEST_N + 1e-9, tag


@pytest.fixture(scope="module")
def fig9_a005(mlp):
    """fig9's a0.05 points, 16 trials, both packages on their own draws."""
    from benchmarks.fig8_9_cell_errors import fig_sweep

    _, j_ev, t_ev = mlp
    j_sweep = dataclasses.replace(fig_sweep("fig9", j_prop, (0.05,)),
                                  trials=STAT_TRIALS, test_n=TEST_N)
    return j_sweep, J.run_sweep(j_sweep, j_ev), T.run_sweep(to_port(j_sweep),
                                                            t_ev)


def test_classifier_statistics_match_reference(fig9_a005):
    """Each point's mean over 16 trials lies within 3 combined standard
    errors of the reference's (population stds over the trials)."""
    j_sweep, j_res, t_res = fig9_a005
    for jr in j_res:
        tr = t_res[jr.tag]
        se = math.sqrt(jr.std ** 2 / STAT_TRIALS + tr.std ** 2 / STAT_TRIALS)
        assert se > 0, jr.tag
        assert abs(tr.mean - jr.mean) <= 3 * se, (jr.tag, tr.mean, jr.mean, se)


def test_classifier_noisy_points_on_reference_conductances(
        mlp, fig9_a005, monkeypatch):
    """The reference's programmed conductances injected per (layer, trial):
    each trial's accuracy within 2 samples of the reference's."""
    params, _, t_ev = mlp
    j_sweep, j_res, _ = fig9_a005
    trials = 2
    tags = ("offset_bpcNone_a0.05", "differential_bpcNone_a0.05")
    j_pts = {p.tag: p for p in j_sweep.expand()}
    injected = {}
    for tag in tags:
        spec = j_pts[tag].spec
        pms = [JA.program_codes(w, spec) for w, _ in params]
        root = jax.random.PRNGKey(j_sweep.seed)
        for t, t_seed in enumerate(T.trial_keys(j_sweep.seed, trials)):
            key = jax.random.fold_in(root, t)
            for i, pm in enumerate(pms):
                aw = JA.program_from_codes(pm, spec, jax.random.fold_in(key, i))
                injected[(tag, TE.fold_seed(t_seed, i))] = aw
    current = {}

    def fake(pm, spec, seed):
        aw = injected[(current["tag"], seed)]
        g = [None if a is None else torch.tensor(np.asarray(a))
             for a in (aw.g_pos, aw.g_neg, aw.g_unit)]
        assert g[0].shape[-1] == pm.n
        return TA.AnalogWeights(g_pos=g[0], g_neg=g[1], g_unit=g[2],
                                w_scale=pm.w_scale, k=pm.k, n=pm.n)

    monkeypatch.setattr(t_evaluate, "program_from_codes", fake)
    for tag in tags:
        current["tag"] = tag
        sweep = T.SweepSpec.from_points(
            tag, [(tag, to_port(j_pts[tag].spec))], trials=trials,
            test_n=TEST_N, seed=j_sweep.seed)
        got = T.run_sweep(sweep, t_ev)[tag].values
        want = j_res[tag].values[:trials]
        assert np.all(np.abs(np.subtract(got, want)) <= 2 / TEST_N + 1e-9), \
            (tag, got, want)


@pytest.mark.parametrize("fig", ["fig8", "fig9"])
def test_paper_claim_differential_beats_offset_on_port(mlp, fig):
    """Figs. 8/9 on the port's own draws: at every slicing and alpha the
    differential mapping is at least as accurate as offset."""
    from benchmarks.fig8_9_cell_errors import ALPHAS_IND, ALPHAS_PROP, fig_sweep

    _, _, t_ev = mlp
    make, alphas = (j_ind, ALPHAS_IND) if fig == "fig8" else (j_prop,
                                                              ALPHAS_PROP)
    sweep = dataclasses.replace(to_port(fig_sweep(fig, make, alphas)),
                                trials=2, test_n=TEST_N)
    res = T.run_sweep(sweep, t_ev)
    for bpc in ("bpcNone", "bpc2"):
        for a in alphas:
            diff = res.mean(f"differential_{bpc}_a{a}")
            off = res.mean(f"offset_{bpc}_a{a}")
            assert diff >= off, (fig, bpc, a, diff, off)


# ---------------------------------------------------------------------------
# ServeEvaluator against the reference, on the trained smoke LM
# ---------------------------------------------------------------------------

#: tests/test_serve_sweep.py's executor-vs-serial bounds
TOP1_FLIP_TOKENS = 4
DECODE_NEW = 8
MATCH_ATOL = DECODE_NEW / (4 * DECODE_NEW) + 1e-9


@pytest.fixture(scope="module")
def lm():
    """The trained smoke LM and lm_accuracy's batches, in both packages."""
    from benchmarks.lm_accuracy import (CALIB_STEP, EVAL_STEP, N_PROMPTS,
                                        PROMPT_LEN, trained_lm)

    j_cfg, ds, j_params = trained_lm()
    calib = np.asarray(ds.batch(CALIB_STEP)["tokens"])
    eb = ds.batch(EVAL_STEP)
    tokens, targets = np.asarray(eb["tokens"]), np.asarray(eb["targets"])
    prompts = tokens[:N_PROMPTS, :PROMPT_LEN]
    cfg = get_smoke_config("qwen1.5-4b")
    params = interop.load_params_npz(NPZ, device=DEV)
    t_ev = T.ServeEvaluator(cfg, params, calib, tokens, targets,
                            prompts=prompts, decode_new=DECODE_NEW)
    return j_cfg, j_params, cfg, params, (calib, tokens, targets, prompts), \
        t_ev


def _lm_alpha_sweep(trials=2):
    from benchmarks.lm_accuracy import lm_sweep

    return dataclasses.replace(
        lm_sweep(), name="lm_eq", axes=(
            J.Axis("error.alpha", (0.02, 0.05), labels=("a0.02", "a0.05")),),
        trials=trials)


def test_serve_evaluator_on_reference_pack_matches_reference(lm, monkeypatch):
    """The reference's programmed packs injected per (point, trial): the
    port calibrates, evaluates and decodes them."""
    j_cfg, j_params, cfg, params, data, t_ev = lm
    calib, tokens, targets, prompts = data
    j_sweep = _lm_alpha_sweep()
    j_ev = J.ServeEvaluator(j_cfg, j_params, calib, tokens, targets,
                            prompts=prompts, decode_new=DECODE_NEW)
    j_res = J.run_sweep(j_sweep, j_ev)
    j_pts = {p.tag: p for p in j_sweep.expand()}
    seeds = T.trial_keys(j_sweep.seed, j_sweep.trials)

    def fake(cfg_, codes, spec, seed):
        t = seeds.index(seed)
        tag = next(tag for tag, p in j_pts.items()
                   if to_port(p.spec) == spec)
        j_pack = JAE.program_lm(
            j_cfg, j_params, j_pts[tag].spec,
            jax.random.fold_in(jax.random.PRNGKey(j_sweep.seed), t))
        j_pack = dataclasses.replace(j_pack, head_act=jnp.zeros(()))
        return interop.pack_from_numpy(_export_pack(j_pack), spec, cfg_,
                                       device=DEV)

    monkeypatch.setattr(t_serve_eval, "program_lm_from_codes", fake)
    t_res = T.run_sweep(to_port(j_sweep), t_ev)
    n_eval = targets.size
    for jr in j_res:
        for got, want in zip(t_res[jr.tag].values, jr.values):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                                       err_msg=jr.tag)
            assert abs(got["top1"] - want["top1"]) \
                <= TOP1_FLIP_TOKENS / n_eval + 1e-9, jr.tag
            assert abs(got["decode_match"] - want["decode_match"]) \
                <= MATCH_ATOL, jr.tag


def _serial(lm, spec, sweep):
    _, _, cfg, params, (calib, tokens, targets, prompts), _ = lm
    if sweep.test_n is not None:
        tokens, targets = tokens[:sweep.test_n], targets[:sweep.test_n]
    return T.serve_serial_reference(
        cfg, params, spec, calib, tokens, targets, prompts=prompts,
        decode_new=DECODE_NEW, trials=sweep.trials, seed=sweep.seed)


def _grid(name):
    from benchmarks.driftbench import drift_sweep
    from benchmarks.hetero_precision import hetero_sweep
    from benchmarks.lm_accuracy import lm_parasitics_sweep

    return {"lm_alpha": lambda: _lm_alpha_sweep(trials=2),
            "lm_parasitics": lambda: dataclasses.replace(
                lm_parasitics_sweep(smoke=True), trials=1),
            "hetero": lambda: dataclasses.replace(
                hetero_sweep(smoke=True), trials=1),
            "drift": lambda: dataclasses.replace(
                drift_sweep(smoke=True), trials=1)}[name]()


@pytest.mark.parametrize("grid", ["lm_alpha", "lm_parasitics", "hetero",
                                  "drift"])
def test_serve_executor_matches_serial(lm, grid):
    """run_sweep == serve_serial_reference, metric for metric, on a global
    spec grid, the r_hat axis, a hetero profile grid and a drift grid."""
    t_ev = lm[-1]
    sweep = to_port(_grid(grid))
    res = T.run_sweep(sweep, t_ev)
    pts = sweep.expand()
    assert len(res) == len(pts)
    for r in res:
        assert r.values == _serial(lm, pts[r.index].spec, sweep), r.tag
        assert all(np.isfinite(v["loss"]) for v in r.values)
    if grid == "drift":
        # the fresh age reproduces the point without aging
        fresh = next(p for p in pts if p.tag.endswith("_t1"))
        still = dataclasses.replace(fresh.spec, drift=TE.DriftModel(),
                                    fault=TE.FaultModel())
        assert res[fresh.tag].values == _serial(lm, still, sweep)


def test_lm_claim_proportional_beats_offset_on_port(lm):
    """lm_accuracy's claim on the port: proportional mapping's loss below
    offset's at 8b a0.05, over 3 trials."""
    from benchmarks.lm_accuracy import lm_sweep

    sweep = to_port(dataclasses.replace(lm_sweep(smoke=True), trials=3))
    res = T.run_sweep(sweep, lm[-1])
    prop = res.metric("proportional_8b_a0.05", "loss")
    off = res.metric("offset_8b_a0.05", "loss")
    assert prop < off, (prop, off)


def test_serve_evaluator_signature_and_codes_cache(lm):
    j_cfg, j_params, cfg, params, (calib, tokens, targets, prompts), t_ev = lm
    j_ev = J.ServeEvaluator(j_cfg, j_params, calib, tokens, targets,
                            prompts=prompts, decode_new=DECODE_NEW)
    assert t_ev.signature() != j_ev.signature()
    assert t_ev.signature().startswith("serve/qwen1.5-4b/torch-v1/")
    # the per-site codes key is the reference's, the head included
    for sweep in (_grid("hetero"), _grid("lm_alpha")):
        for p in sweep.expand():
            assert t_ev._codes_key(to_port(p.spec)) == j_ev._codes_key(p.spec)


def test_analog_eval_loss(lm):
    _, _, cfg, params, (calib, tokens, targets, _), _ = lm
    spec = TA.design_a(error=TE.state_proportional(0.05))
    pack = TAE.calibrate_lm(cfg, params, TAE.program_lm(cfg, params, spec, 3),
                            calib)
    loss = TAE.analog_eval_loss(cfg, params, pack, tokens, targets)
    assert torch.equal(loss, TAE.analog_eval_metrics(
        cfg, params, pack, tokens, targets)["loss"])


def test_runtime_agreements_hold_their_contract(lm):
    """runtime_agreement, fused_runtime_agreement and
    paged_runtime_agreement on the port: 1.0, analog and digital; and
    pack_with_fused rewrites every spec and shares every tensor."""
    _, _, cfg, params, (calib, _, _, _), _ = lm
    spec = TA.design_a(error=TE.state_proportional(0.05), fused="kernel")
    pack = TAE.calibrate_lm(cfg, params,
                            TAE.program_lm(cfg, params, spec, 11), calib)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), m)
            for n, m in ((5, 6), (11, 4), (3, 7), (8, 5), (2, 3))]
    for p in (pack, None):
        assert t_serve_eval.runtime_agreement(cfg, params, reqs,
                                              pack=p) == 1.0
        assert t_serve_eval.fused_runtime_agreement(cfg, params, reqs,
                                                    pack=p) == 1.0
        assert t_serve_eval.paged_runtime_agreement(cfg, params, reqs,
                                                    pack=p) == 1.0
    oracle = t_serve_eval.pack_with_fused(pack, "oracle")
    assert {s.fused for ss in oracle.band_specs for _, s in ss.items} \
        == {"oracle"}
    assert oracle.head_spec.fused == oracle.profile.default.fused == "oracle"
    assert oracle.layer_weights is pack.layer_weights
    assert t_serve_eval.pack_with_fused(None, "oracle") is None


# ---------------------------------------------------------------------------
# core leftovers: energy, mapping helpers
# ---------------------------------------------------------------------------


def _energy_specs():
    from benchmarks.fig15_16_adc import fig16_sweep
    from benchmarks.table3_energy import DESIGNS, spec_of

    out = [(f"table3_{name}", spec_of(s, b, r, a), g)
           for name, s, b, r, a, g, _, _ in DESIGNS]
    out += [(f"fig16_{p.tag}", p.spec, 0.02) for p in fig16_sweep().expand()]
    return out


@pytest.mark.parametrize("name", [n for n, _, _ in _energy_specs()])
def test_energy_equals_reference(name):
    _, j_spec, g_avg = next(e for e in _energy_specs() if e[0] == name)
    t_spec = to_port(j_spec)
    for k, n in ((1152, 256), (2560, 6912), (64, 7)):
        assert TEN.core_energy(t_spec, k, n, g_avg=g_avg) == \
            JEN.core_energy(j_spec, k, n, g_avg=g_avg)
        assert TEN.core_energy(t_spec, k, n, g_avg=g_avg, activity=0.7) == \
            JEN.core_energy(j_spec, k, n, g_avg=g_avg, activity=0.7)
        assert TEN.core_area(t_spec, k, n) == JEN.core_area(j_spec, k, n)
        assert TEN.core_costs(t_spec, k, n, g_avg=g_avg).as_dict() == \
            JEN.core_costs(j_spec, k, n, g_avg=g_avg).as_dict()
        assert TEN.energy_breakdown(t_spec, k, n, g_avg=g_avg) == \
            JEN.energy_breakdown(j_spec, k, n, g_avg=g_avg)
        assert t_spec.adc_conversions_per_mvm(k, n) == \
            j_spec.adc_conversions_per_mvm(k, n)
        for bits in (4, 5, 6, 7, 8, 10):
            jb = dataclasses.replace(j_spec, adc=dataclasses.replace(
                j_spec.adc, bits=bits))
            for scaled in (True, False):
                assert TEN.adc_energy(to_port(jb), k, n,
                                      ramp_scaled=scaled) == \
                    JEN.adc_energy(jb, k, n, ramp_scaled=scaled)


MAPPING_CASES = [(s, b, o) for s in ("offset", "differential")
                 for b in (None, 1, 2, 4)
                 for o in (float("inf"), 100.0, 1e4)]


@pytest.mark.parametrize("scheme,bpc,onoff", MAPPING_CASES)
def test_mapping_helpers_equal_reference(scheme, bpc, onoff):
    rng = np.random.default_rng(hash((scheme, bpc, onoff)) % 2 ** 32)
    w = rng.integers(-127, 128, size=(96, 40)).astype(np.int32)
    jc = JM.MappingConfig(scheme=scheme, bits_per_cell=bpc, on_off_ratio=onoff)
    tc = TM.MappingConfig(scheme=scheme, bits_per_cell=bpc, on_off_ratio=onoff)
    jp = JM.program_weights(jnp.asarray(w), jc)
    tp = TM.program_weights(torch.as_tensor(w), tc)
    for a, b in ((tp.g_pos, jp.g_pos), (tp.g_neg, jp.g_neg),
                 (tp.g_unit, jp.g_unit)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = TM.reconstruct_weights(tp, tc).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(JM.reconstruct_weights(jp, jc)))
    np.testing.assert_allclose(back, w, atol=1e-3)
    # conductance -> codes on perturbed values: the same float32 ops
    g = np.asarray(jp.g_pos) * (1 + 0.05 * rng.standard_normal(
        np.asarray(jp.g_pos).shape)).astype(np.float32)
    np.testing.assert_array_equal(
        TM.conductance_to_codes(torch.as_tensor(g), tc).numpy(),
        np.asarray(JM.conductance_to_codes(jnp.asarray(g), jc)))
    # the per-slice mean: float64 sum rounded once; the reference's float32
    # reduction carries its own rounding error, measured against float64
    j_avg = np.asarray(JM.average_conductance(jp))
    t_avg = TM.average_conductance(tp).numpy()
    exact = np.concatenate(
        [np.asarray(x, np.float64).reshape(np.asarray(x).shape[0], -1)
         for x in (jp.g_pos, jp.g_neg) if x is not None], -1).mean(-1)
    ulp = np.spacing(j_avg)
    assert np.all(np.abs(t_avg - j_avg) <= ulp + np.abs(j_avg - exact)), \
        (t_avg, j_avg, exact)
    if bpc is not None:
        c = rng.integers(0, 256, size=(96, 40)).astype(np.int32)
        s = JM.slice_codes(jnp.asarray(c), bpc, -(-8 // bpc))
        np.testing.assert_array_equal(
            TM.unslice_codes(torch.as_tensor(np.asarray(s)), bpc).numpy(),
            np.asarray(JM.unslice_codes(s, bpc)))
        np.testing.assert_array_equal(
            TM.unslice_codes(TM.slice_codes(torch.as_tensor(c), bpc,
                                            -(-8 // bpc)), bpc).numpy(), c)


try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # only the two properties below skip
    given = None

SETTINGS = dict(max_examples=30, deadline=None)

if given is not None:
    @given(codes=st.lists(st.integers(0, 255), min_size=1, max_size=32),
           bpc=st.sampled_from([1, 2, 4]))
    @settings(**SETTINGS)
    def test_port_slice_unslice_roundtrip(codes, bpc):
        c = torch.as_tensor(codes, dtype=torch.int32)
        s = TM.slice_codes(c, bpc, -(-8 // bpc))
        assert bool((s >= 0).all()) and bool((s < 2 ** bpc).all())
        np.testing.assert_array_equal(TM.unslice_codes(s, bpc).numpy(),
                                      codes)

    @given(vals=st.lists(st.integers(-127, 127), min_size=2, max_size=64),
           scheme=st.sampled_from(["offset", "differential"]),
           bpc=st.sampled_from([None, 1, 2, 4]),
           onoff=st.sampled_from([float("inf"), 100.0, 10.0]))
    @settings(**SETTINGS)
    def test_port_program_reconstruct_roundtrip(vals, scheme, bpc, onoff):
        w = torch.as_tensor(vals, dtype=torch.int32).reshape(-1, 1)
        mc = TM.MappingConfig(scheme=scheme, bits_per_cell=bpc,
                              on_off_ratio=onoff)
        pw = TM.program_weights(w, mc)
        back = TM.reconstruct_weights(pw, mc)
        np.testing.assert_allclose(back.numpy(), w.numpy(), atol=1e-3)
        for g in (pw.g_pos, pw.g_neg):
            if g is not None:
                assert bool((g >= mc.g_min - 1e-6).all())
                assert bool((g <= 1.0 + 1e-6).all())
else:
    def test_port_slice_unslice_roundtrip():
        pytest.skip("hypothesis is not installed")

    def test_port_program_reconstruct_roundtrip():
        pytest.skip("hypothesis is not installed")


def test_port_energy_model_monotonicity():
    def spec(**kw):
        kw.setdefault("mapping", TM.MappingConfig(scheme="differential"))
        kw.setdefault("input_accum", "analog")
        kw.setdefault("max_rows", 1152)
        return TA.AnalogSpec(adc=TADC.ADCConfig(bits=8), **kw)

    base = spec()
    e_base = TEN.core_energy(base, g_avg=0.02)
    assert TEN.core_energy(spec(mapping=TM.MappingConfig(
        scheme="differential", bits_per_cell=1)), g_avg=0.02) > e_base
    assert TEN.core_energy(spec(max_rows=144), g_avg=0.02) > e_base
    assert TEN.core_energy(spec(input_accum="digital"), g_avg=0.02) > e_base
    assert TEN.core_energy(base, g_avg=0.5) > e_base
