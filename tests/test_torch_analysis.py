"""The port's analyzer (``repro_torch.analysis``) against the reference's
(``repro.analysis``) on the CPU.

* Fixtures under ``tests/fixtures/analysis_torch/`` pin every port rule to
  exact ``(rule, line)`` findings, and their good twins clean.
* ``bare-assert`` and ``silent-except`` give the reference's findings on
  every file of both packages and of the reference's fixtures, and the
  copied walker builds the reference's alias and function tables there.
* Baselines written by either package gate the other's findings;
  suppressions are rule-scoped; the CLI gates.
* ``src/repro_torch`` analyzes clean with the committed empty baseline,
  and every hot root the ``host-sync`` rule names exists.
* The five static contracts hold and partition as the reference's do; the
  six trace contracts hold at smoke size; the fused signatures equal the
  reference's ``BUILD_SIGNATURES`` on the reference's own pack, and the
  paged prefill group keys equal the reference's ``_prefill_fns`` keys.
* The ``scalar-div`` repairs: each chosen form equals the reference's
  compiled float32 output where the IEEE division does not.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import Baseline as JBaseline
from repro.analysis import analyze_file as j_analyze_file
from repro.analysis import analyze_paths as j_analyze_paths
from repro.analysis.repo_contracts import static_contracts as j_static
from repro.analysis.walker import parse_module as j_parse_module
from repro_torch.analysis import (
    Baseline,
    CompileContract,
    Finding,
    analyze_file,
    analyze_paths,
    analyze_source,
    check_contract,
    rule_ids,
    step_launches,
    template_leak_violations,
)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import repo_contracts as R
from repro_torch.analysis import rules as T_rules
from repro_torch.analysis.walker import parse_module
from repro_torch.kernels import ops

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
FIXTURES = os.path.join(HERE, "fixtures", "analysis_torch")
J_FIXTURES = os.path.join(HERE, "fixtures", "analysis")


def _fix(name):
    return os.path.join(FIXTURES, name)


def _rules_at(findings):
    return [(f.rule, f.line) for f in findings]


def _py_files(*roots):
    out = []
    for root in roots:
        for d, dirs, names in os.walk(root):
            dirs[:] = sorted(x for x in dirs if x != "__pycache__")
            out.extend(os.path.join(d, n) for n in sorted(names)
                       if n.endswith(".py"))
    return out


# ---------------------------------------------------------------------------
# each port rule: exact findings on its bad fixture, none on its good one
# ---------------------------------------------------------------------------

BAD = {
    "bad_rng_global.py": [("rng-global", 6), ("rng-global", 7),
                          ("rng-global", 8)],
    "bad_rng_seed.py": [("rng-seed", 9), ("rng-seed", 10), ("rng-seed", 11),
                        ("rng-seed", 12)],
    "bad_host_sync.py": [("host-sync", 9), ("host-sync", 13),
                         ("host-sync", 14), ("host-sync", 15),
                         ("host-sync", 15), ("host-sync", 20),
                         ("host-sync", 20)],
    "bad_scalar_div.py": [("scalar-div", 13), ("scalar-div", 20),
                          ("scalar-div", 25), ("scalar-div", 26),
                          ("scalar-div", 26)],
    "bad_tf32.py": [("tf32-toggle", 4), ("tf32-toggle", 5),
                    ("tf32-toggle", 6)],
    "bad_assert_except.py": [("bare-assert", 5), ("silent-except", 12)],
    "bad_rounding.cu": [("csrc-rounding", 5), ("csrc-rounding", 5),
                        ("csrc-rounding", 8), ("csrc-rounding", 9),
                        ("csrc-rounding", 10)],
}
GOOD = ["good_rng_global.py", "good_rng_seed.py", "good_host_sync.py",
        "good_scalar_div.py", "good_tf32.py", "good_assert_except.py",
        "good_rounding.cu", "outside_contract.cu"]


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_fixture_exact_findings(name):
    assert _rules_at(analyze_file(_fix(name))) == BAD[name]


@pytest.mark.parametrize("name", GOOD)
def test_good_fixture_is_clean(name):
    assert analyze_file(_fix(name)) == []


def test_every_port_rule_has_a_bad_fixture():
    pinned = {r for want in BAD.values() for r, _ in want}
    assert pinned == set(rule_ids())


def test_host_sync_names_each_site():
    fs = analyze_file(_fix("bad_host_sync.py"))
    sites = {f.msg.split(" inside")[0] for f in fs}
    assert sites == {"int()", ".cpu()", "torch.cuda.synchronize()",
                     ".item()", "np.asarray", "float()", ".tolist()"}
    # the cold function's .item() is not reachable from a hot root
    assert all(f.line < 23 for f in fs)


def test_scalar_div_names_the_divisor():
    fs = analyze_file(_fix("bad_scalar_div.py"))
    assert [f.msg.split("'")[1] for f in fs] == [
        "sampler.temperature", "half", "3", "n", "0.7"]


def test_rng_seed_meta_device_exempt():
    src = ("import torch\n"
           "def f():\n"
           "    return torch.zeros(2, device='meta').normal_(\n"
           "        generator=torch.Generator(device='meta')\n"
           "        .manual_seed(0))\n")
    assert analyze_source(src) == []


def test_csrc_scope_header_and_includers_only():
    body = "__device__ float f(float a, float b) { return a * b; }\n"
    assert _rules_at(analyze_source(body, "csrc/analog.cuh")) == [
        ("csrc-rounding", 1)]
    assert analyze_source(body, "csrc/other.cuh") == []
    assert analyze_source(body, "csrc/flash_decode.cu") == []
    inc = '#include "analog.cuh"\n' + body
    assert _rules_at(analyze_source(inc, "csrc/x.cu")) == [
        ("csrc-rounding", 2)]
    sup = inc.replace("a * b;", "a * b;  // repro: ignore[csrc-rounding] ok")
    assert analyze_source(sup, "csrc/x.cu") == []


def test_syntax_error_reported_as_finding():
    fs = analyze_source("def f(:\n", path="broken.py")
    assert len(fs) == 1 and fs[0].rule == "syntax-error"


def test_suppression_is_rule_scoped():
    src = ("import torch\n"
           "def f(x: torch.Tensor):\n"
           "    return x / 3  # repro: ignore[host-sync]\n")
    assert [f.rule for f in analyze_source(src)] == ["scalar-div"]
    src = src.replace("host-sync", "scalar-div")
    assert analyze_source(src) == []


# ---------------------------------------------------------------------------
# held to the reference analyzer
# ---------------------------------------------------------------------------

SHARED_RULES = ["bare-assert", "silent-except"]


def test_guard_rules_equal_the_reference_on_both_packages():
    paths = [os.path.join(SRC, "repro"), os.path.join(SRC, "repro_torch"),
             J_FIXTURES]
    key = lambda f: (f.path, f.line, f.rule, f.msg)  # noqa: E731
    got = sorted(map(key, analyze_paths(paths, only=SHARED_RULES)))
    want = sorted(map(key, j_analyze_paths(paths, only=SHARED_RULES)))
    assert got == want
    assert any(f[0].endswith("bad_assert_except.py") for f in got)


def test_walker_tables_equal_the_reference():
    files = _py_files(os.path.join(SRC, "repro"),
                      os.path.join(SRC, "repro_torch"), J_FIXTURES)
    assert len(files) > 100
    for path in files:
        src = open(path).read()
        a, b = parse_module(src, path), j_parse_module(src, path)
        assert a.aliases == b.aliases, path
        assert [(f.name, f.node.lineno if hasattr(f.node, "lineno") else 0,
                 getattr(f.parent, "lineno", None)) for f in a.functions] \
            == [(f.name, f.node.lineno if hasattr(f.node, "lineno") else 0,
                 getattr(f.parent, "lineno", None)) for f in b.functions], \
            path


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_baseline_written_by_either_package_gates_the_other(writer, tmp_path):
    name = os.path.join(J_FIXTURES, "bad_assert_except.py")
    t_fs = analyze_file(name, only=SHARED_RULES)
    j_fs = j_analyze_file(name, only=SHARED_RULES)
    assert len(t_fs) == 2
    p = str(tmp_path / "baseline.json")
    if writer == "reference":
        JBaseline.write(p, j_fs)
        assert Baseline.load(p).filter(t_fs) == []
    else:
        Baseline.write(p, t_fs)
        assert JBaseline.load(p).filter(j_fs) == []
    assert json.load(open(p))[0].keys() == {"rule", "path", "msg"}
    moved = [Finding(f.rule, f.path, f.line + 3, f.msg) for f in t_fs]
    assert Baseline.load(p).filter(moved) == []
    other = [Finding("scalar-div", "x.py", 1, "msg")]
    assert Baseline.load(p).filter(other) == other


# ---------------------------------------------------------------------------
# the shipped tree
# ---------------------------------------------------------------------------


def test_zero_false_positives_on_src_repro_torch():
    """The gate: the port (Python and csrc) analyzes clean, with the
    committed baseline empty."""
    pkg = os.path.join(SRC, "repro_torch")
    assert analyze_paths([pkg]) == []
    assert json.load(open(cli.DEFAULT_BASELINE)) == []
    csrc = [f for f in os.listdir(os.path.join(pkg, "kernels", "csrc"))]
    assert {"analog.cuh", "fused_mvm.cu", "bitline.cu"} <= set(csrc)


@pytest.mark.parametrize("module", sorted(T_rules.HOT_ROOTS))
def test_every_hot_root_exists(module):
    path = os.path.join(SRC, module)
    mod = parse_module(open(path).read(), path)
    found = {T_rules._qualname(mod, r) for r in T_rules.hot_roots(mod)}
    assert found == set(T_rules.HOT_ROOTS[module])


def test_hot_roots_reach_the_sampling_path():
    path = os.path.join(SRC, "repro_torch", "serve", "runtime.py")
    mod = parse_module(open(path).read(), path)
    reach = {getattr(f, "name", "") for f in
             T_rules._reachable(mod, T_rules.hot_roots(mod))}
    assert {"_run_decode", "_decode_model", "sample_tokens", "temper",
            "_prefill", "_start_rows"} <= reach
    assert "_collect" not in reach


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_ci_green_on_shipped_tree():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--ci"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "analysis clean" in r.stdout


@pytest.mark.parametrize("name", sorted(BAD))
def test_cli_exits_nonzero_on_bad_fixture(name, capsys):
    assert cli.main(["--ci", "--contracts", "none", _fix(name)]) == 1
    assert BAD[name][0][0] in capsys.readouterr().out


def test_cli_baseline_gates(tmp_path, capsys):
    p = str(tmp_path / "bl.json")
    Baseline.write(p, analyze_file(_fix("bad_scalar_div.py")))
    assert cli.main(["--ci", "--contracts", "none", "--baseline", p,
                     _fix("bad_scalar_div.py")]) == 0
    assert "baselined" in capsys.readouterr().out
    assert cli.main(["--ci", "--contracts", "none", "--baseline", p,
                     _fix("bad_tf32.py")]) == 1


def test_cli_list_rules(capsys):
    assert cli.main(["--list-rules"]) == 0
    assert set(capsys.readouterr().out.split()) == set(rule_ids()) == {
        "bare-assert", "silent-except", "rng-global", "rng-seed",
        "host-sync", "scalar-div", "tf32-toggle", "csrc-rounding"}


# ---------------------------------------------------------------------------
# contracts: static level, against the reference's partition
# ---------------------------------------------------------------------------


def _partition(contract, compile_groups, point_key):
    ev = contract.evaluator()
    pts = contract.sweep.expand()
    proto = contract.sweep.point_protocol()
    groups = compile_groups(
        [(point_key(ev.signature(), p, proto), p) for p in pts], ev)
    return len(pts), sorted(dyn for _, dyn, _ in groups)


def test_static_contracts_hold_and_partition_as_the_reference():
    from repro.sweep.executor import compile_groups as j_groups
    from repro.sweep.results import point_key as j_key
    from repro_torch.sweep.executor import compile_groups
    from repro_torch.sweep.results import point_key

    ours = R.static_contracts()
    ref = {c.name: c for c in j_static()}
    assert [c.name for c in ours] == list(ref)
    for c in ours:
        assert check_contract(c, "static") == [], c.name
        assert _partition(c, compile_groups, point_key) == \
            _partition(ref[c.name], j_groups, j_key), c.name


def test_contract_detects_budget_violation():
    wrong = {c.name: c for c in R.static_contracts()}[
        "sweep/alpha-axis-one-group"]
    v = check_contract(dataclasses.replace(wrong, max_groups=0), "static")
    assert len(v) == 1 and "budget is 0" in v[0].msg
    v = check_contract(
        dataclasses.replace(wrong, require_dynamic=("nope.field",)), "static")
    assert len(v) == 1 and "nope.field" in v[0].msg
    v = check_contract(
        dataclasses.replace(wrong, expect_dynamic=((),)), "static")
    assert len(v) == 1 and "allowed sets" in v[0].msg
    v = check_contract(dataclasses.replace(wrong, min_groups=5), "static")
    assert len(v) == 1 and "at least 5" in v[0].msg


def test_contract_findings_are_findings():
    wrong = dataclasses.replace(R.static_contracts()[0], max_groups=0)
    (f,) = check_contract(wrong, "static")
    assert f.rule == "compile-contract"
    assert f.path == f"contract {wrong.name!r}"
    assert f.line == 0


def test_trace_budget_violation_is_a_finding():
    c = CompileContract(name="t", run=lambda: ["boom"])
    (f,) = check_contract(c, "trace")
    assert (f.rule, f.msg) == ("compile-contract", "boom")
    ev = R._evaluator("cpu")
    ev._pm_cache.update(a=[], b=[])
    c = CompileContract(name="t2", run=lambda: None, entries=lambda: [ev],
                        max_compiles=1)
    (f,) = check_contract(c, "trace")
    assert "2 compilations, budget is 1" in f.msg


# ---------------------------------------------------------------------------
# contracts: trace level at smoke size
# ---------------------------------------------------------------------------

TRACE_NAMES = ["sweep/alpha-axis-programs-once",
               "serve/decode-launches-fixed",
               "serve/paged-decode-launches-fixed",
               "serve/paged-prefill-group-launches",
               "serve/fused-signature-per-site-class",
               "sweep/dynamic-fields-flow-from-row"]


@pytest.fixture(scope="module")
def trace_suite():
    return {c.name: c for c in R.trace_contracts("cpu")}


@pytest.mark.parametrize("name", TRACE_NAMES)
def test_trace_contract_holds_on_cpu(name, trace_suite):
    assert list(trace_suite) == TRACE_NAMES
    assert check_contract(trace_suite[name], "trace") == []


def test_decode_launches_count_per_step():
    cfg, params, pack = R.serve_vehicle("cpu")
    _, rec, built = R.serve_dense((cfg, params, pack))
    want = {"fused_mvm": 7 * cfg.n_layers + 1, "flash_decode": cfg.n_layers}
    assert len(rec.decode) > 5 and all(d == want for d in rec.decode)
    assert built == {("linear", 1, 7, 8, None, None)}
    # a digital runtime launches only the attention kernel
    _, rec, built = R.serve_dense((cfg, params, None))
    assert all(d == {"flash_decode": cfg.n_layers} for d in rec.decode)
    assert built == set()


def test_step_launches_sees_a_changed_step():
    """The recorder catches a step that launches one kernel more."""
    cfg, params, pack = R.serve_vehicle("cpu")
    from repro_torch.serve import ServeRuntime

    rt = ServeRuntime(cfg, params, pack=pack, max_slots=2, max_len=32,
                      attn_backend="flash")
    inner = rt._run_decode
    calls = []

    def extra():
        calls.append(1)
        if len(calls) == 2:
            args, kw = _tiny_mvm()
            ops.fused_mvm(*args, **kw)
        return inner()

    rt._run_decode = extra
    with step_launches(rt) as rec:
        rt.submit(np.arange(5, dtype=np.int32), max_new_tokens=4)
        rt.run()
    assert len(rec.decode_violations("x")) == 1
    assert rec.decode[1]["fused_mvm"] == rec.decode[0]["fused_mvm"] + 1


def _tiny_mvm():
    x = torch.zeros((1, 1, 4))
    g = torch.ones((1, 1, 4, 2))
    return (x, g, g), dict(adc_lo=torch.zeros(1), adc_hi=torch.ones(1),
                           adc_bits=8, cell_bits=1, n_bits=None, scale=1.0)


def test_template_leak_is_detected():
    from repro_torch.core import errors as E
    from repro_torch.core.adc import ADCConfig
    from repro_torch.core.analog import AnalogSpec
    from repro_torch.sweep.evaluate import materialize

    template = AnalogSpec(adc=ADCConfig(style="none"),
                          error=E.state_proportional(0.05))

    def good(tmpl, row):
        spec = materialize(tmpl, row)
        return spec, spec.error.alpha

    def leaky(tmpl, row):       # ignores its row: reads the template
        return tmpl, tmpl.error.alpha

    row = {"error.alpha": 0.02}
    assert template_leak_violations(good, template, row, (0.0123,)) == []
    v = template_leak_violations(leaky, template, row, (0.0123,))
    assert len(v) == 2 and "error.alpha" in v[0] and "moves" in v[1]


# ---------------------------------------------------------------------------
# against the reference's serving: signatures and paged prefill groups
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_fused():
    """The reference's fused-signature contract trace: its own Design-A
    pack (programmed, calibrated, on the fused route) served over 6
    requests; returns the pack, the trace and its BUILD_SIGNATURES."""
    from repro.configs import get_smoke_config
    from repro.core.analog import design_a
    from repro.core.errors import ErrorModel
    from repro.kernels import fused as kfused
    from repro.models.registry import get_model
    from repro.serve import ServeRuntime
    from repro.serve.analog_engine import calibrate_lm, program_lm
    from repro.sweep.serve_eval import pack_with_fused

    cfg = get_smoke_config("qwen1.5-4b")
    params = get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    calib = rng.integers(0, cfg.vocab, size=(2, 24)).astype(np.int32)
    pack = program_lm(cfg, params, design_a(error=ErrorModel()),
                      jax.random.PRNGKey(1))
    pack = pack_with_fused(calibrate_lm(cfg, params, pack, calib), "kernel")
    reqs = []
    for i in range(6):
        prompt = rng.integers(
            0, cfg.vocab, size=int(rng.integers(3, 13))).astype(np.int32)
        reqs.append((prompt, int(rng.integers(2, 7))))
    kfused.BUILD_SIGNATURES.clear()
    rt = ServeRuntime(cfg, params, pack=pack, max_slots=3, max_len=32,
                      attn_backend="flash")
    for i, (p, m) in enumerate(reqs):
        rt.submit(p, max_new_tokens=m, uid=i)
    rt.run()
    return params, pack, reqs, set(kfused.BUILD_SIGNATURES)


def test_fused_signatures_equal_the_reference_on_its_pack(ref_fused):
    from test_torch_model import _export_pack

    from repro_torch import interop
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.analog import design_a
    from repro_torch.core.errors import ErrorModel
    from repro_torch.serve import ServeRuntime

    j_params, j_pack, reqs, j_sigs = ref_fused
    cfg = get_smoke_config("qwen1.5-4b")
    params = interop.params_from_numpy(
        jax.tree.map(np.asarray, j_params), device="cpu")
    pack = interop.pack_from_numpy(
        _export_pack(j_pack), design_a(error=ErrorModel(), fused="kernel"),
        cfg, device="cpu")
    ops.BUILD_SIGNATURES.clear()
    rt = ServeRuntime(cfg, params, pack=pack, max_slots=3, max_len=32,
                      attn_backend="flash")
    with step_launches(rt) as rec:
        for i, (p, m) in enumerate(reqs):
            rt.submit(p, max_new_tokens=m, uid=i)
        rt.run()
    assert j_sigs and set(ops.BUILD_SIGNATURES) == j_sigs
    assert rec.decode_violations(
        "ref pack", R.expected_step_launches(cfg, pack, "flash_decode")) == []
    c = R.fused_signature_contract((cfg, params, pack), "cpu")
    assert check_contract(c, "trace") == []


def test_paged_prefill_keys_equal_the_reference():
    from repro.analysis import repo_contracts as JR

    JR._paged_run()
    j_keys = set(JR._paged_state["rt"]._prefill_fns)
    _, rec = R.serve_paged(R.serve_vehicle("cpu"))
    assert set(rec.prefill) == j_keys
    assert rec.prefill_violations("paged") == []


# ---------------------------------------------------------------------------
# the scalar-div repairs, held to the reference's compiled float32 forms
# ---------------------------------------------------------------------------


def test_tempered_logits_equal_the_reference_compiled_division():
    from repro_torch.serve.runtime import SamplerConfig, temper

    sampler = SamplerConfig(kind="temperature", temperature=0.7)
    lg = (np.random.default_rng(3).standard_normal((4, 4096)) * 6) \
        .astype(np.float32)
    want = np.asarray(jax.jit(
        lambda x: x.astype(jnp.float32) / sampler.temperature)(lg))
    got = temper(torch.from_numpy(lg), sampler.temperature).numpy()
    np.testing.assert_array_equal(got, want)
    ieee = (torch.from_numpy(lg) / 0.7).numpy()      # the CPU's division
    assert (ieee != want).any()


def test_rope_equals_the_reference_at_a_non_power_of_two_half():
    """zamba2-7b's attention heads are 112 wide (half 56): RoPE's
    frequencies equal the reference's jitted ones to the bit, and its
    output within 2 ulp of the largest magnitude (cos/sin/pow differ by
    an ulp between the libraries)."""
    from repro.models import layers as JL
    from repro_torch.configs import get_config
    from repro_torch.core.quant import div_as_compiled
    from repro_torch.models import layers as TL

    cfg = get_config("zamba2-7b")
    hd = cfg.hd
    assert hd == 112
    half = hd // 2
    theta = float(cfg.rope_theta)
    idx = np.arange(hd)
    want = np.asarray(jax.jit(
        lambda i: theta ** (-(i % half).astype(jnp.float32) / half))(idx))
    tf = theta ** div_as_compiled(
        -(torch.arange(hd) % half).to(torch.float32), half)
    np.testing.assert_array_equal(tf.numpy(), want)
    ieee = theta ** (-(torch.arange(hd) % half).to(torch.float32) / half)
    assert (ieee.numpy() != want).any()
    xr = np.random.default_rng(1).standard_normal((2, 5, 3, hd)) \
        .astype(np.float32)
    pr = np.arange(5, dtype=np.int32) + 7
    ref = np.asarray(jax.jit(JL.rope, static_argnums=2)(xr, pr, theta))
    out = TL.rope(torch.from_numpy(xr), torch.from_numpy(pr), theta).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2 * np.spacing(np.abs(ref).max()))


def test_moe_fraction_equals_the_reference_compiled_division():
    """The load-balance fraction ``ce`` (``mlp.py``'s bincount over
    ``t * k``) as the reference's jitted scatter-add over ``t * k``."""
    from repro_torch.core.quant import div_as_compiled

    departs = False
    for t, k, e in ((15, 2, 4), (24, 8, 16), (33, 3, 8)):
        topi = np.random.default_rng(t).integers(0, e, (t, k))
        want = np.asarray(jax.jit(
            lambda ti: jnp.zeros((e,), jnp.float32).at[ti.reshape(-1)].add(
                jnp.ones((t * k,), jnp.float32)) / (t * k))(topi))
        counts = torch.bincount(torch.from_numpy(topi).reshape(-1),
                                minlength=e).to(torch.float32)
        np.testing.assert_array_equal(
            div_as_compiled(counts, t * k).numpy(), want)
        departs |= bool(((counts / (t * k)).numpy() != want).any())
    assert departs


def test_moe_block_lb_loss_holds_to_the_compiled_reference():
    from repro.config import ModelConfig as JCfg
    from repro.models import mlp as JMLP
    from repro_torch import interop
    from repro_torch.config import ModelConfig as TCfg
    from repro_torch.models import mlp as TMLP

    kw = dict(name="moe", family="transformer", n_layers=1, d_model=16,
              n_heads=2, n_kv_heads=2, d_ff=32, vocab=64, n_experts=4,
              top_k=2, moe_d_ff=32, capacity_factor=4.0)
    jc, tc = JCfg(**kw), TCfg(**kw)
    p = jax.tree.map(lambda a: a[0], JMLP.init_moe(
        jax.random.PRNGKey(2), jc, 1, jnp.float32))
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, p),
                                   device="cpu")
    x = np.random.default_rng(6).standard_normal((3, 5, 16)) \
        .astype(np.float32)
    _, lbj = jax.jit(lambda pp, xx: JMLP.moe_block(pp, xx, jc))(p, x)
    _, lbt = TMLP.moe_block(pt, torch.from_numpy(x), tc)
    np.testing.assert_allclose(float(lbt), float(lbj), rtol=2e-7)


def test_sinusoid_exponent_equals_the_reference_compiled_division():
    """whisper's sinusoid table at d 1280: the exponent ``2 * dim / d`` as
    the reference's jitted program computes it."""
    from repro_torch.core.quant import div_as_compiled

    d = 1280
    dim = np.arange(d // 2, dtype=np.float32)[None, :]
    want = np.asarray(jax.jit(lambda dm: 2 * dm / d)(dim))
    got = div_as_compiled(2 * torch.from_numpy(dim), d).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((2 * torch.from_numpy(dim) / d).numpy() != want).any()
