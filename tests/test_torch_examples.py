"""The port's examples (``repro_torch.examples``) against the reference's
``examples/*.py``, on the CPU.

The reference's side of each example runs in JAX subprocesses started
with the module (the reference's compiles take most of the time, and
they run beside each other and beside the port's side here); each writes
what the reference computed, its trained parameters and programmed
conductances included, to a directory of the module's.  The port's
evaluation functions are then given the reference's parameters and
conductances (``interop``), so that only the arithmetic downstream of
them is compared; where the port draws its own noise, the comparison is
by statistics.

* quickstart: the ideal output within the fused bound of
  ``kernels.tolerance`` (2 float32 ulps or a quarter of the dequant grid
  step); on the reference's conductances both designs' outputs within
  twice it (ulps of the offset design's magnitude before its correction
  cancels it), but for one-code ADC flips (at most 1 in 1000 outputs),
  and both relative errors within what that bound allows; the port's own
  programming draws over 8 seeds on the same inputs, each design's mean
  error within 3 combined standard errors of the reference's over 4;
  Design A below Design E.
* hetero_profile: the per-site energy table equal to the reference's row
  for row; on the reference's trained LM (the committed smoke LM) and its
  programmed mixed pack the digital loss within 1e-5 and the analog loss
  within 1e-4 relative (the sweep tests' bound on the LM loss).
* analog_serve: its loss and greedy serving on the reference's pack of
  the example's offset Design E on the same LM: the analog loss within
  2e-3 relative (the reference's own loss moves by 1.4e-3 between two of
  its compilations), and the greedy tokens through the pack equal but
  where a row first departs at a near tie of the reference's logits
  (``tests/test_torch_model.py``'s rule; the digital greedy tokens are
  held there).
* serve_loop: the trace's uids, prompts and budgets equal to the
  reference example's draws; the example's runtime through the
  reference's mixed pack serves every request with the uid, prompt
  length and completion length of the reference's runtime on the same
  trace and pack; sampled tokens are not compared.
* design_space: on the reference's trained MLP and eval splits
  (``TEST_N`` test examples), the unsliced differential design's and the
  offset design's accuracies (1 trial of the reference's) within 3 trial
  spreads (the port's, over 3 trials) of the port's, and every design's
  energy and area columns equal; the port's
  ``train_mlp`` reaches a digital accuracy within 2 points of the
  reference's.
* train_lm: at smoke width, a run interrupted after a checkpoint and
  resumed equals an uninterrupted one, every leaf ``torch.equal``.
"""

import dataclasses
import inspect
import os
import pickle
import statistics
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import analog as TA
from repro_torch.core import energy as TEN
from repro_torch.core.adc import ADCConfig
from repro_torch.core.quant import quantize_acts
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.examples import analog_serve as AS
from repro_torch.examples import classifier as CL
from repro_torch.examples import design_space as DS
from repro_torch.examples import hetero_profile as HP
from repro_torch.examples import quickstart as QS
from repro_torch.examples import serve_loop as SL
from repro_torch.examples import train_lm as TL
from repro_torch.kernels import tolerance
from repro_torch.pytree import flatten_with_path
from repro_torch.sweep import ClassifierEvaluator
from repro_torch.train.step import loss_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "benchmarks", "_cache", "lm_qwen1_5-4b_0.npz")
DEV = "cpu"
LOSS_REL = 1e-5          # digital loss, as the digital logits
ANALOG_LOSS_REL = 1e-4   # analog loss on the reference's pack
#: analog loss on the reference's pack of the offset Design E: its outputs
#: are ~2% of what they reach before the offset correction, so each
#: float rounding weighs ~50 times more, and ADC and input codes flip; the
#: reference's own loss on this pack moves by 1.4e-3 relative between
#: XLA's backend optimisation level 0 (its job here) and the default, and
#: by 2.3e-4 between compiled and eager (the port's lies between them)
ANALOG_E_LOSS_REL = 2e-3
FLIP_SHARE = 1e-3        # one-code ADC flips allowed among the outputs
QS_SEEDS = tuple(range(8))   # the port's programming seeds of the statistics
REF_QS_SEEDS = (0, 1, 2, 3)  # the reference's
TEST_N = 512
DESIGN_E = "E  offset/2b/digital-accum + SONOS"   # of ``AS.designs()``
PORT_TRIALS = 3          # the port's trials of each design point
ACC_POINTS = 0.02        # train_mlp's digital accuracy against the reference's
REF_WALL_S = 600

#: the reference's jobs, one subprocess each: (the function it runs,
#: its XLA_FLAGS).  Eigen on one thread: the jobs share the cores with
#: each other and the port.  LLVM's optimisation changes the machine code
#: only, not the compiled HLO, and halves the compile time of the
#: compiled jobs; quickstart's eager Design E runs slower without it.
ONE_THREAD = "--xla_cpu_multi_thread_eigen=false"
FAST_COMPILE = (ONE_THREAD + " --xla_backend_optimization_level=0"
                " --xla_llvm_disable_expensive_passes=true")
REF_JOBS = (("quick", ONE_THREAD), ("lm", FAST_COMPILE),
            ("lm_e", FAST_COMPILE), ("mlp", FAST_COMPILE),
            ("mlp_points", FAST_COMPILE))
#: the design_space points held against the reference's accuracy (of
#: ``DS.DESIGNS``; each costs the reference 5-15 s of compiling): the
#: unsliced differential design and the offset design; every point's
#: energy and area are held
REF_POINTS = (0, 4)

REF_BODY = r'''
import os, pickle, sys, time
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)
BATCHES = pickle.load(open(os.path.join(OUT, "batches.pkl"), "rb"))


def save(name, obj):
    path = os.path.join(OUT, name)
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(obj, fh)
    os.rename(path + ".tmp", path)


def quick():
    from repro.core import analog as A
    from repro.core import errors as E
    from repro.core.adc import ADCConfig
    from repro.core.mapping import MappingConfig

    w = jax.random.laplace(jax.random.PRNGKey(0), (1152, 256)) * 0.02
    x, xc = (jax.nn.relu(jax.random.normal(jax.random.PRNGKey(s),
                                           (64, 1152))) for s in (1, 2))
    spec0 = dataclasses.replace(A.design_a(), adc=ADCConfig(style="none"))
    ideal = A.analog_matmul(x, A.program(w, spec0), spec0)
    out = {"w": np.asarray(w), "x": np.asarray(x), "xc": np.asarray(xc),
           "ideal": np.asarray(ideal), "designs": []}
    for spec in (A.design_a(error=E.sonos()),
                 A.AnalogSpec(mapping=MappingConfig(scheme="offset",
                                                    bits_per_cell=2),
                              adc=ADCConfig(style="calibrated", bits=8),
                              error=E.sonos(), input_accum="digital",
                              max_rows=72)):
        def output(aw, stats, spec=spec):
            y = A.analog_matmul(x, aw, spec, adc_lo=stats[:, 0],
                                adc_hi=stats[:, 1])
            return y, jnp.sqrt(jnp.mean((y - ideal) ** 2)) / jnp.std(ideal)

        def run(key, spec=spec):
            aw = A.program(w, spec, key)
            _, stats = A.analog_matmul(xc, aw, spec, collect=True)
            return aw, stats, output(aw, stats)[1]

        # the example's draw (key 42) and the statistics' draws compiled
        # all at once (an eager Design E takes ~10 s a draw); the draw's
        # output eager, as the example runs (compiled, XLA sums in other
        # orders)
        aw, stats, errs = jax.jit(jax.vmap(run))(jnp.stack(
            [jax.random.PRNGKey(s) for s in (42,) + SEEDS]))
        aw, stats = jax.tree.map(lambda a: a[0], (aw, stats))
        y, err = output(aw, stats)
        out["designs"].append({
            "aw": {k: None if getattr(aw, k) is None else
                   np.asarray(getattr(aw, k))
                   for k in ("g_pos", "g_neg", "g_unit", "w_scale")},
            "y": np.asarray(y), "err": float(err),
            "errs": [float(e) for e in errs[1:]]})
    save("quick", out)


def _np_tree(path):
    """The committed LM's parameters as the reference's nested dict (the
    npz's keys are its paths, ``['a']['b']``)."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.strip("[]'").split("']['")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(z[key])
    return tree


def _export(pack):
    """A reference AnalogPack as the nested numpy dict
    ``interop.pack_from_numpy`` reads."""
    def weights(aw):
        return {"g_pos": np.asarray(aw.g_pos),
                "g_neg": None if aw.g_neg is None else np.asarray(aw.g_neg),
                "g_unit": None if aw.g_unit is None else np.asarray(aw.g_unit),
                "w_scale": np.asarray(aw.w_scale), "k": aw.k, "n": aw.n}

    def arrays(d):
        return {k: np.asarray(v) for k, v in d.items()}

    return {
        "layer_weights": {n: weights(aw)
                          for n, aw in pack.layer_weights.items()},
        "layer_lo": arrays(pack.layer_lo), "layer_hi": arrays(pack.layer_hi),
        "layer_act": arrays(pack.layer_act),
        "head": None if pack.head is None else weights(pack.head),
        "head_lo": np.asarray(pack.head_lo),
        "head_hi": np.asarray(pack.head_hi),
        "head_act": np.asarray(pack.head_act),
    }


def _lm(spec):
    """The committed smoke LM, ``spec``'s pack on it (programmed with key
    7, calibrated compiled on the calibration batch) and the evaluation
    batch."""
    from repro.configs import get_smoke_config
    from repro.serve import analog_engine as AE

    cfg = get_smoke_config("qwen1.5-4b")
    params = _np_tree(NPZ)
    pack = AE.program_lm(cfg, params, spec, jax.random.PRNGKey(7))
    pack = jax.jit(lambda p, pk, c: AE.calibrate_lm(cfg, p, pk, c))(
        params, pack, jnp.asarray(BATCHES["calib"]))
    batch = {k: jnp.asarray(v) for k, v in BATCHES["eval"].items()}
    return cfg, params, pack, batch


def _analog_loss(cfg, params, pack, batch):
    from repro.serve import analog_engine as AE

    return float(AE.analog_eval_loss(cfg, params, pack, batch["tokens"],
                                     batch["targets"]))


def lm():
    from repro.core import analog as A
    from repro.core import energy as EN
    from repro.core import errors as E
    from repro.hw import DIGITAL, Profile, site_class
    from repro.serve import SamplerConfig, ServeRuntime
    from repro.train import step as S

    # hetero_profile's mixed pack, its losses and energy table
    attn = A.design_a(error=E.state_proportional(0.05))
    mlp = dataclasses.replace(attn, adc=dataclasses.replace(attn.adc, bits=6))
    prof = Profile.by_class(attn=attn, mlp=mlp, head=DIGITAL)
    cfg, params, pack, batch = _lm(prof)
    energy = []
    for name, aw in sorted(pack.layer_weights.items()):
        spec = pack.site_spec(name)
        energy.append((name, site_class(name), f"{aw.k}x{aw.n}",
                       spec.adc.bits, spec.adc_conversions_per_mvm(aw.k, aw.n),
                       EN.adc_energy(spec, aw.k, aw.n)))
    out = {"pack": _export(pack), "energy": energy,
           "losses": (float(S.loss_fn(cfg, params, batch)[0]),
                      _analog_loss(cfg, params, pack, batch))}
    # serve_loop's runtime settings on that pack, serving the port's trace
    rt = ServeRuntime(
        cfg, params, pack=pack, max_slots=4, max_len=48, buckets=(8, 16),
        sampler=SamplerConfig(kind="top_k", top_k=8, temperature=0.9),
        seed=0)
    for uid, prompt, budget in BATCHES["trace"]:
        rt.submit(prompt, max_new_tokens=budget, uid=uid)
    done = []
    while not rt.idle:
        done += [(c.uid, c.prompt_len, len(c.tokens)) for c in rt.step()]
    out["served"] = {"completions": sorted(done),
                     "tokens_out": rt.stats["tokens_out"]}
    save("lm", out)


def lm_e():
    from repro.core import analog as A
    from repro.core import errors as E
    from repro.models import transformer as T
    from repro.serve import analog_engine as AE

    # analog_serve's offset Design E: its analog loss and greedy tokens
    cfg, params, pack, batch = _lm(A.design_e(error=E.sonos()))
    prompts = batch["tokens"][:4, :8]
    toks = AE.decode_lm(cfg, params, prompts, 8, pack=pack)
    # the logits of each of its own greedy steps: where the port first
    # departs, the gap of their top two
    seq = jnp.concatenate([prompts, toks[:, :-1]], axis=1)
    lg = T.forward(cfg, params, seq, pack=pack, remat=False)[0][:, 7:]
    top2 = jnp.sort(lg, axis=-1)[..., -2:]
    save("lm_e", {"pack": _export(pack),
                  "loss": _analog_loss(cfg, params, pack, batch),
                  "tokens": np.asarray(toks),
                  "gap": np.asarray(top2[..., 1] - top2[..., 0]),
                  "scale": np.asarray(jnp.abs(lg).max(axis=-1))})


def _point(ev, i):
    """The reference's accuracy of ``DESIGNS[i]``, one trial on
    ``TEST_N`` test examples."""
    import repro.sweep as J
    from repro.core import analog as A
    from repro.core import errors as E
    from repro.core.adc import ADCConfig
    from repro.core.mapping import MappingConfig

    scheme, bpc, rows, accum = DESIGNS[i]
    spec = A.AnalogSpec(
        mapping=MappingConfig(scheme=scheme, bits_per_cell=bpc,
                              on_off_ratio=E.SONOS_ON_OFF),
        adc=ADCConfig(style="calibrated", bits=8), error=E.sonos(),
        input_accum=accum, max_rows=rows)
    sweep = J.SweepSpec.from_points(f"point{i}", [("p", spec)], trials=1,
                                    test_n=TEST_N)
    return J.run_sweep(sweep, ev)["p"].mean


def mlp():
    """The reference's MLP and splits, its digital accuracy and its
    accuracy at ``POINTS[0]``."""
    import benchmarks.common as C
    import repro.sweep as J

    C.CACHE = OUT
    params = C.train_mlp()
    xca, _, xte, yte = C.eval_data()
    save("mlp_data", {"params": [(np.asarray(w), np.asarray(b))
                                 for w, b in params],
                      "xca": np.asarray(xca), "xte": np.asarray(xte),
                      "yte": np.asarray(yte)})
    save("mlp_digital", C.digital_accuracy(params))
    save(f"mlp_point{POINTS[0]}",
         _point(J.ClassifierEvaluator(params, xca, xte, yte), POINTS[0]))


def mlp_points():
    """The reference's accuracy at the other ``POINTS``, on ``mlp``'s MLP
    and splits once it has written them."""
    import repro.sweep as J

    path = os.path.join(OUT, "mlp_data")
    while not os.path.exists(path):
        time.sleep(0.1)
    with open(path, "rb") as fh:
        d = pickle.load(fh)
    params = [(jnp.asarray(w), jnp.asarray(b)) for w, b in d["params"]]
    ev = J.ClassifierEvaluator(params, *(jnp.asarray(d[k]) for k in
                                         ("xca", "xte", "yte")))
    for i in POINTS[1:]:
        save(f"mlp_point{i}", _point(ev, i))
'''


def _batches() -> dict:
    """The port's data for the reference: hetero_profile's calibration
    and evaluation batches of the smoke stream, as numpy."""
    ds = SyntheticLM(cfg=get_smoke_config("qwen1.5-4b"), seq_len=32,
                     global_batch=8, seed=0, device=DEV)
    return {"calib": ds.batch(998)["tokens"].numpy(),
            "eval": {k: v.numpy() for k, v in ds.batch(999).items()},
            "trace": SL.trace(ds.cfg.vocab)}


@pytest.fixture(scope="module", autouse=True)
def ref_procs(tmp_path_factory):
    """The reference's subprocesses, started with the module; this
    process's torch on 2 threads meanwhile (more oversubscribe the cores
    the reference's jobs share, and spin)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    out = str(tmp_path_factory.mktemp("examples_ref"))
    with open(os.path.join(out, "batches.pkl"), "wb") as fh:
        pickle.dump(_batches(), fh)
    head = (f"REPO = {REPO!r}\nOUT = {out!r}\nNPZ = {NPZ!r}\n"
            f"SEEDS = {REF_QS_SEEDS!r}\nTEST_N = {TEST_N}\n"
            f"POINTS = {REF_POINTS!r}\n"
            f"DESIGNS = {[d[:4] for d in DS.DESIGNS]!r}\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", head + REF_BODY + f"\n{name}()\n"],
        env=dict(env, XLA_FLAGS=flags), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
        for name, flags in REF_JOBS}
    yield out, procs
    torch.set_num_threads(threads)
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _ref(ref_procs, name: str, job: str = None):
    """What the reference's job ``job`` (``name``'s own by default) saved
    as ``name``, once it is there."""
    out, procs = ref_procs
    proc = procs[job or name]
    path = os.path.join(out, name)
    deadline = time.monotonic() + REF_WALL_S
    while not os.path.exists(path):
        if proc.poll() is not None and not os.path.exists(path):
            _, err = proc.communicate()
            raise AssertionError(f"reference job {job or name} exited "
                                 f"{proc.returncode}:\n{err[-4000:]}")
        assert time.monotonic() < deadline, f"{name} not written"
        time.sleep(0.1)
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _rel(got, want):
    return abs(got - want) / abs(want)


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------


def test_train_lm_resume_equals_uninterrupted(tmp_path):
    """At smoke width (2 layers of 64, 4 x 16 tokens), 8 steps saving
    every 3: a run stopped after step 5 (its last checkpoint at 3) and
    run again on the same directory resumes from 3 and ends equal to one
    run straight through, every leaf ``torch.equal``; the last two
    checkpoints are kept.  The save interval's default is 100."""
    assert inspect.signature(TL.train).parameters["save_every"].default \
        == 100
    cfg = dataclasses.replace(TL.CONFIG, n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=4, d_ff=96, vocab=128)
    kw = dict(device=DEV, seq_len=16, global_batch=4, save_every=3)
    logs = []
    whole, o1 = TL.train(cfg, steps=8, ckpt_dir=str(tmp_path / "a"),
                         log=lambda *_: None, **kw)
    _, o2 = TL.train(cfg, steps=8, ckpt_dir=str(tmp_path / "b"),
                     stop_after=5, log=lambda *_: None, **kw)
    resumed, o3 = TL.train(cfg, steps=8, ckpt_dir=str(tmp_path / "b"),
                           log=logs.append, **kw)
    assert o1["kept"] == [3, 6] and o2["kept"] == [3]
    assert o3["start"] == 3 and o3["kept"] == [3, 6]
    assert logs[0] == "resumed from step 3"
    assert o1["losses"][3:] == o3["losses"]
    a, b = dict(flatten_with_path(whole)), dict(flatten_with_path(resumed))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# design_space and the classifier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_mlp(tmp_path_factory):
    """The port's own trained MLP (trained while the reference's jobs
    run), its cache directory and its digital accuracy."""
    cache = str(tmp_path_factory.mktemp("mlp"))
    params = CL.train_mlp(device=DEV, cache_dir=cache)
    return params, cache, CL.digital_accuracy(params)


def test_train_mlp_reads_its_cache(port_mlp):
    """A second ``train_mlp`` reads the first's weights back from its
    cache directory, to the bit.  (First of this section: the port's
    training runs while the reference's jobs start.)"""
    params, cache, _ = port_mlp
    again = CL.train_mlp(device=DEV, cache_dir=cache)
    assert len(again) == len(CL.DIMS) - 1
    assert all(torch.equal(a, b) for (wa, ba), (wb, bb) in zip(params, again)
               for a, b in ((wa, wb), (ba, bb)))


def test_design_space_on_reference_mlp(ref_procs):
    """The five designs on the reference's MLP and splits: each
    ``REF_POINTS`` reference accuracy (1 trial; the reference takes 5-15
    s a point to compile) within 3 trial spreads of the port's
    mean over ``PORT_TRIALS`` of its own draws (the port's spread
    standing for both: its std over the trials, times sqrt(1 + 1 /
    ``PORT_TRIALS``) for the difference, plus one test example), and
    every design's energy and area columns equal the reference's
    ``core_costs``."""
    from repro.core import analog as JA
    from repro.core import energy as JEN
    from repro.core import errors as JE
    from repro.core.adc import ADCConfig as JADC
    from repro.core.mapping import MappingConfig as JMC

    data = _ref(ref_procs, "mlp_data", "mlp")
    ev = ClassifierEvaluator(data["params"], data["xca"], data["xte"],
                             data["yte"], device=DEV)
    designs = [DS.DESIGNS[i] for i in REF_POINTS]
    rows = DS.evaluate(ev, DS.sweep(designs, trials=PORT_TRIALS,
                                    test_n=TEST_N),
                       designs=designs, cache_dir=None)
    ref = {i: _ref(ref_procs, f"mlp_point{i}",
                   "mlp" if i == REF_POINTS[0] else "mlp_points")
           for i in REF_POINTS}
    for i, (tag, acc, std, fj, mm2) in zip(REF_POINTS, rows):
        spread = std * (1 + 1 / PORT_TRIALS) ** 0.5
        print(f"{tag}: port {acc:.4f} +- {std:.4f} over "
              f"{PORT_TRIALS} trials, reference {ref[i]}")
        assert tag == DS.name_of(*DS.DESIGNS[i][:4])
        assert abs(ref[i] - acc) <= 3 * spread + 1 / TEST_N
    sweep = DS.sweep()
    for i, (scheme, bpc, max_rows, accum, g_avg) in enumerate(DS.DESIGNS):
        c = JEN.core_costs(JA.AnalogSpec(
            mapping=JMC(scheme=scheme, bits_per_cell=bpc,
                        on_off_ratio=JE.SONOS_ON_OFF),
            adc=JADC(style="calibrated", bits=8), error=JE.sonos(),
            input_accum=accum, max_rows=max_rows), g_avg=g_avg)
        t = TEN.core_costs(sweep.explicit[i][1], g_avg=g_avg)
        assert (t.energy_fj_per_op, t.area_mm2) == (c.energy_fj_per_op,
                                                    c.area_mm2)
        if i in REF_POINTS:
            assert rows[REF_POINTS.index(i)][3:] == (t.energy_fj_per_op,
                                                    t.area_mm2)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quick(ref_procs):
    """The reference's inputs, ideal output and, per design, conductances
    programmed with key 42, output and relative error, and its errors
    over ``QS_SEEDS``; the port's ideal output."""
    ref = _ref(ref_procs, "quick")
    ref["port_ideal"] = QS.ideal_output(_t(ref["w"]), _t(ref["x"]))
    return ref


def _weights(aw: dict) -> TA.AnalogWeights:
    return TA.AnalogWeights(g_pos=_t(aw["g_pos"]), g_neg=_t(aw["g_neg"]),
                            g_unit=_t(aw["g_unit"]),
                            w_scale=_t(aw["w_scale"]), k=QS.K, n=QS.N)


def _grid(spec, aw, x, xc) -> float:
    """The smallest step of ``spec``'s output on ``aw``: one ADC code of
    the lowest slice and input bit, gain * w_scale * x_scale * lsb, the
    lsb the narrowest calibrated range (on ``xc``) over 2^bits - 1; an
    ADC-free spec's step is one unit of the dot product."""
    m = spec.mapping
    gain = (m.levels_per_cell - 1) / (1.0 - m.g_min)
    qmax = 2 ** (spec.input_bits - 1) - 1 if spec.signed_inputs \
        else 2 ** spec.input_bits - 1
    lsb = 1.0
    if spec.adc.style != "none":
        _, stats = TA.analog_matmul(xc, aw, spec, collect=True)
        lsb = float((stats[:, 1] - stats[:, 0]).min()) \
            / (2 ** spec.adc.bits - 1)
    return gain * float(aw.w_scale) * float(x.abs().max()) / qmax * lsb


def _bound(y):
    """The fused bound's float part: 2 ulps of each output's magnitude."""
    return tolerance.FUSED_ULP * tolerance._spacing(y.abs())


def _offset_magnitude(spec, aw, x):
    """The magnitude each output of an offset design reaches before its
    offset correction (``offset_code * sum(x_int)``, in output units)
    cancels most of it; 0 for a differential design."""
    m = spec.mapping
    if m.scheme == "differential":
        return torch.zeros(())
    xq = quantize_acts(x, spec.input_bits, signed=spec.signed_inputs)
    return (m.offset_code * xq.values.sum(-1))[:, None] * aw.w_scale \
        * xq.scale


def test_quickstart_ideal_output_within_the_fused_bound(quick):
    w_t, x_t = _t(quick["w"]), _t(quick["x"])
    got, want = quick["port_ideal"], _t(quick["ideal"])
    spec0 = dataclasses.replace(TA.design_a(), adc=ADCConfig(style="none"))
    grid = _grid(spec0, TA.program(w_t, spec0), x_t, None)
    d = (got - want).abs()
    ok = (d <= _bound(want)) | (d <= tolerance.FUSED_CODES * grid)
    print(f"ideal: max diff {float(d.max()):.3e}, grid step {grid:.3e}")
    assert ok.all(), float(d[~ok].max())


def test_quickstart_on_reference_conductances(quick):
    """Each design's output on the reference's programmed conductances:
    each side within the fused bound (2 ulps, or a quarter of the
    smallest ADC code step) of the exact value, so within twice it of
    each other — the ulps taken of the magnitude before the offset
    design's correction cancels it (its outputs are ~2% of ``offset_code
    * sum(x_int)``, summed in another order than the reference's) — but
    for one-code flips of an ADC at a rounding edge, at most
    ``FLIP_SHARE`` of the outputs; the relative error then within the rms
    of the differences (and of the ideal outputs') over std(ideal) of
    the reference's."""
    x_t, xc_t = _t(quick["x"]), _t(quick["xc"])
    ideal_t = quick["port_ideal"]
    sd = torch.std(ideal_t, correction=0)
    for (name, spec), ref in zip(QS.designs(), quick["designs"]):
        aw = _weights(ref["aw"])
        y = QS.calibrated_output(aw, spec, x_t, xc_t)
        want = _t(ref["y"])
        d = (y - want).abs()
        grid = _grid(spec, aw, x_t, xc_t)
        # each side within 2 ulps of the magnitude before cancellation
        mag = torch.maximum(want.abs(), _offset_magnitude(spec, aw, x_t))
        flips = int(((d > 2 * _bound(mag))
                     & (d > tolerance.FUSED_CODES * grid)).sum())
        err = QS.relative_error(y, ideal_t)
        allowed = float(torch.sqrt(torch.mean(d ** 2)) / sd) + float(
            torch.sqrt(torch.mean((ideal_t - _t(quick["ideal"])) ** 2)) / sd)
        print(f"{name}: port {err:.6f}, reference {ref['err']:.6f}; {flips} "
              f"outputs past the bound, max diff {float(d.max()):.3e}, "
              f"grid step {grid:.3e}")
        assert flips <= FLIP_SHARE * d.numel()
        assert abs(err - ref["err"]) <= allowed \
            + 2 * tolerance.F32_EPS * ref["err"]


def test_quickstart_statistics_over_seeds(quick):
    """The port's own programming draws over ``QS_SEEDS`` against the
    reference's over ``REF_QS_SEEDS`` (compiled), both on the reference's
    inputs: each design's mean relative error within 3 combined standard
    errors; Design A below Design E in both."""
    w_t, x_t, xc_t = _t(quick["w"]), _t(quick["x"]), _t(quick["xc"])
    means = []
    for (name, spec), ref in zip(QS.designs(), quick["designs"]):
        port = [QS.relative_error(QS.calibrated_output(
            TA.program(w_t, spec, s), spec, x_t, xc_t), quick["port_ideal"])
            for s in QS_SEEDS]
        se = (statistics.variance(port) / len(port)
              + statistics.variance(ref["errs"]) / len(ref["errs"])) ** 0.5
        mp, mr = statistics.fmean(port), statistics.fmean(ref["errs"])
        print(f"{name}: port {mp:.5f} +- {statistics.stdev(port):.5f} over "
              f"{len(port)} draws, reference {mr:.5f} "
              f"+- {statistics.stdev(ref['errs']):.5f} over "
              f"{len(ref['errs'])}")
        assert abs(mp - mr) <= 3 * se
        means.append((mp, mr))
    assert means[0][0] < means[1][0] and means[0][1] < means[1][1]


def test_quickstart_main_prints_both_designs(capsys):
    errs = QS.main(["--device", DEV])
    out = capsys.readouterr().out
    assert [n for n, _ in errs] == [n for n, _ in QS.designs()]
    assert all(n in out for n, _ in errs)
    assert np.isfinite([e for _, e in errs]).all() and errs[0][1] < errs[1][1]


# ---------------------------------------------------------------------------
# the LM examples, on the committed smoke LM (trained by the reference)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm(ref_procs):
    """The reference's side of hetero_profile and serve_loop (its mixed
    pack imported), the smoke config, the committed parameters and the
    evaluation batch."""
    ref = _ref(ref_procs, "lm")
    ref["pack"] = _import_pack(ref["pack"], HP.profile())
    with open(os.path.join(ref_procs[0], "batches.pkl"), "rb") as fh:
        batch = pickle.load(fh)["eval"]
    return (ref, get_smoke_config("qwen1.5-4b"),
            interop.load_params_npz(NPZ, device=DEV),
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _import_pack(exported: dict, spec):
    """The port's copy of a reference pack exported under ``spec`` (a
    digital head's ranges come out as object arrays of None, read back as
    None)."""
    for k in ("head_lo", "head_hi", "head_act"):
        if exported[k] is not None and exported[k].dtype == object:
            exported[k] = None
    return interop.pack_from_numpy(exported, spec,
                                   get_smoke_config("qwen1.5-4b"), device=DEV)


def _losses_match(got, want):
    """The port's (digital, analog) losses against the reference's."""
    print(f"digital loss port {got[0]:.7f} reference {want[0]:.7f}; analog "
          f"port {got[1]:.7f} reference {want[1]:.7f}")
    assert _rel(got[0], want[0]) <= LOSS_REL
    assert _rel(got[1], want[1]) <= ANALOG_LOSS_REL


def test_hetero_profile_on_reference_pack(lm):
    ref, cfg, params, batch = lm
    pack = ref["pack"]
    dig, al, toks = HP.evaluate(cfg, params, pack, batch)
    _losses_match((dig, al), ref["losses"])
    assert toks.shape == (2, 6) and pack.head is None
    # the energy table of the reference's pack and of the port's own
    ds = SyntheticLM(cfg=cfg, seq_len=32, global_batch=8, seed=0,
                     device=DEV)
    own = HP.program(cfg, params, ds)
    assert own.head is None
    assert HP.energy_table(own) == HP.energy_table(pack) == ref["energy"]


def test_analog_serve_on_reference_pack(lm, ref_procs):
    """analog_serve's loss and serving functions (its own LM is the smoke
    gemma-2b; they take any config and pack) on the reference's pack of
    the example's offset Design E (SONOS errors, key 7, calibrated on the
    calibration batch): the analog loss within ``ANALOG_E_LOSS_REL``
    (the reference's own spread across its compilations), and the greedy
    tokens through the pack equal but where a row first departs at a near
    tie of the reference's logits."""
    _, cfg, params, batch = lm
    want = _ref(ref_procs, "lm_e")
    pack = _import_pack(want["pack"], AS.designs()[DESIGN_E])
    got = AS.analog_loss(cfg, params, pack, batch)
    print(f"design E analog loss port {got:.7f} reference "
          f"{want['loss']:.7f}")
    assert _rel(got, want["loss"]) <= ANALOG_E_LOSS_REL
    analog, digital, match = AS.serve(cfg, params, pack,
                                      batch["tokens"][:4, :8])
    print(f"agreement with digital serving: port {match}")
    assert digital.shape == analog.shape == (4, 8)
    for row in range(analog.shape[0]):
        diff = np.nonzero(analog[row].numpy() != want["tokens"][row])[0]
        if diff.size:
            i = int(diff[0])
            assert want["gap"][row, i] < 1e-4 * want["scale"][row, i], (
                f"row {row} leaves the reference at step {i} away from a "
                f"near tie")


def test_serve_loop_trace_matches_reference(lm):
    """The reference example's trace (its ``np.random.default_rng(0)``
    draws, written out here): the same uids, prompts and budgets; served
    by the example's runtime settings through the reference's mixed pack,
    the completions' uids, prompt lengths and lengths equal those of the
    reference's ``ServeRuntime`` serving the same trace through that pack
    with the same settings, and ``tokens_out`` their sum."""
    ref, cfg, params, _ = lm
    rng = np.random.default_rng(0)
    want = []
    for i in range(10):
        prompt = rng.integers(0, cfg.vocab, size=int(rng.integers(3, 15)))
        want.append((i, prompt, int(rng.integers(4, 17))))
    requests = SL.trace(cfg.vocab)
    assert [(u, b) for u, _, b in requests] == [(u, b) for u, _, b in want]
    assert all(np.array_equal(p, q) for (_, p, _), (_, q, _) in
               zip(requests, want))
    rt = SL.runtime(cfg, params, ref["pack"])
    done = SL.serve(rt, requests, log=lambda *_: None)
    got = sorted((c.uid, c.prompt_len, len(c.tokens)) for c in done)
    print(got)
    assert got == [tuple(c) for c in ref["served"]["completions"]]
    assert rt.stats["tokens_out"] == ref["served"]["tokens_out"] \
        == sum(len(c.tokens) for c in done)


def test_train_mlp_matches_reference_accuracy(ref_procs, port_mlp):
    """The port's ``train_mlp`` against the reference's: digital accuracy
    within ``ACC_POINTS``.  (Last in the module: the reference's digital
    accuracy is the last thing its MLP job computes.)"""
    _, _, got = port_mlp
    want = _ref(ref_procs, "mlp_digital", "mlp")
    print(f"digital accuracy port {got:.4f}, reference {want:.4f}")
    assert abs(got - want) <= ACC_POINTS
