"""Runs of the benchmark's cells at a size a CPU test holds, past the
harness's look for a card: the shape of the last line, the reference
against the port, the import guard, the control under the lower
precision and the faults each cell can have, each of which must read as
not correct.  The plain reference's pieces against their definitions.
One card-marked test runs a cell through the command."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import run  # noqa: E402
from harness import common, smoke  # noqa: E402

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242          # larger than 32 signed bits hold
NO_METRICS = {"metrics_of": lambda kind: []}


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads, as the driver runs several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class _Clock:
    """A host clock that advances ``tick`` seconds at each reading, so a
    window holds the same work however loaded the machine is."""

    def __init__(self, tick: float):
        self.tick, self.now = tick, 0.0

    def perf_counter(self) -> float:
        self.now += self.tick
        return self.now


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    """The sweep loop reads the clock three times a point: a 1-s window at
    0.25 s a reading holds one point."""
    from harness import sweep

    monkeypatch.setattr(sweep, "time", _Clock(0.25))


def _run(cell, *, seconds=1.0, trace=False, control=False, **kw):
    return run.run_cell(cell, SEED, seconds, trace, CPU, control=control,
                        t_start=0.0, **kw)


def test_sweep_line_and_check(capsys):
    cell = smoke.cell("sweep-design-a.rwkv6-3b")
    line, check = _run(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device"]
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == {"setup_s", "point_s"}
    assert all(m["unit"] == "s" for m in line["metrics"].values())
    assert set(check) == {"loss_diff", "tokens_diff"}
    assert all(v["value"] <= v["limit"] for v in check.values())
    common.emit(line, check)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[-1] == "check" and last["check"] == check
    assert err.strip().splitlines()[-1].startswith("check tokens_diff")


def test_traced_line_reads_the_spans():
    cell = smoke.cell("sweep-design-a.rwkv6-3b")
    line, _ = _run(cell, trace=True)
    assert line["correct"] is True
    m = line["metrics"]
    assert m["calibrate_s.point"]["value"] > 0.0
    assert m["eval_s.point"]["value"] > 0.0
    assert m["point_mfu"]["unit"] == "%"
    # no device ran: no device metric is written from a CPU run
    assert not {"device_idle.point", "b1_roofline.point"} & set(m)


@pytest.mark.parametrize("name", ["sweep-parasitic.qwen1.5-4b",
                                  "sweep-design-a.rwkv6-3b"])
def test_control_reads_not_correct(name):
    cell = smoke.cell(name)
    line, check = _run(cell, control=True, **NO_METRICS)
    assert line["correct"] is False
    assert any(v["limit"] < v["value"] < float("inf")
               for v in check.values()), check


def _altered_loss(monkeypatch):
    from repro_torch.sweep import serve_eval

    orig = serve_eval.analog_eval_metrics

    def altered(*a, **kw):
        m = orig(*a, **kw)
        m["loss"] = m["loss"] + 0.05
        return m
    monkeypatch.setattr(serve_eval, "analog_eval_metrics", altered)


def _altered_token(monkeypatch):
    """The first greedy token of each row of a programmed model altered
    where it is produced; the decode goes on from it."""
    from repro_torch.models import transformer

    orig = transformer.prefill

    def altered(*a, **kw):
        logits, cache = orig(*a, **kw)
        if kw.get("pack") is not None:
            logits = logits.clone()
            last = logits[:, -1]
            other = (last.argmax(-1) + 1) % last.shape[-1]
            last[torch.arange(last.shape[0]), other] = last.amax(-1) + 1.0
        return logits, cache
    monkeypatch.setattr(transformer, "prefill", altered)


def _half_batch(monkeypatch):
    from repro_torch.sweep import serve_eval

    orig = serve_eval.analog_eval_metrics

    def half(cfg, params, pack, tokens, targets):
        n = max(1, tokens.shape[0] // 2)
        return orig(cfg, params, pack, tokens[:n], targets[:n])
    monkeypatch.setattr(serve_eval, "analog_eval_metrics", half)


def _uncalibrated(monkeypatch):
    from repro_torch.sweep import serve_eval

    monkeypatch.setattr(serve_eval, "calibrate_lm",
                        lambda cfg, params, pack, *a, **kw: pack)


@pytest.mark.parametrize("name,fault", [
    (name, fault)
    for name in ("sweep-design-a.rwkv6-3b", "sweep-parasitic.qwen1.5-4b")
    for fault in (_altered_loss, _altered_token, _half_batch, _uncalibrated)])
def test_fault_reads_not_correct(monkeypatch, name, fault):
    """Each fault the cell can have, planted in the timed path, fails one
    of its compared numbers at smoke size and at the cell's own limits."""
    fault(monkeypatch)
    line, check = _run(smoke.cell(name), **NO_METRICS)
    assert line["correct"] is False
    limits = common.Cell.named(name).limits
    assert any(limits[k] < v["value"] < float("inf")
               for k, v in check.items()), check


def test_tf32_rounding():
    from reference.analog import tf32

    one = 1.0
    t = torch.tensor([one, one + 2 ** -11, one + 3 * 2 ** -11, -3.0 - 2 ** -9,
                      one + 2 ** -12])
    assert tf32(t).tolist() == [one, one, one + 2 ** -9, -3.0 - 2 ** -9, one]


def test_ladder_is_kirchhoffs_solution():
    """The bottom currents equal those of a dense float64 solve of each
    column's node equations."""
    from reference.analog import ladder_currents

    gen = torch.Generator().manual_seed(5)
    rows, n, r = 12, 3, 0.05
    planes = torch.randint(-1, 2, (2, 1, 2, rows), generator=gen).float()
    g = torch.rand((1, 1, rows, n), generator=gen)
    got = ladder_currents(planes, g, r)                  # (2, 1, 1, 2, n)
    for b in range(2):
        for m in range(2):
            x = planes[b, 0, m].double()
            for j in range(n):
                gj = g[0, 0, :, j].double()
                diag = 2.0 + x.abs() * gj * r
                diag[0] -= 1.0
                a = torch.diag(diag) - torch.diag(torch.ones(rows - 1,
                                                             dtype=torch.float64), 1) \
                    - torch.diag(torch.ones(rows - 1, dtype=torch.float64), -1)
                v = torch.linalg.solve(a, x * gj * r)
                assert abs(float(got[b, 0, 0, m, j]) - float(v[-1] / r)) \
                    < 1e-4 * (1.0 + abs(float(v[-1] / r)))


def test_percentile_is_numpys_linear_one():
    """numpy's linear percentile, the rank taken in float32: exact where
    the rank is, else within a thousandth of the gap it falls in."""
    from reference.analog import percentile

    v = torch.randn(10007, generator=torch.Generator().manual_seed(2))
    s = torch.sort(v).values
    for q in (0.01, 12.5, 50.0, 99.99):
        want = float(np.percentile(v.double().numpy(), q))
        i = int(q / 100 * 10006)
        gap = float(s[min(i + 1, 10006)] - s[i])
        tol = 1e-6 if q in (12.5, 50.0) else 1e-3 * gap
        assert abs(float(percentile(s, q)) - want) <= tol + 1e-6 * abs(want)


def test_programming_by_hand():
    """Codes, conductances and arrays of a tiny matrix, error-free."""
    from reference import analog as A

    d = A.Design(max_rows=2)
    w = torch.tensor([[1.27, -0.64], [0.0, 0.01], [-1.27, 0.64]])
    arr = A.program(w, d, None)
    assert arr.g_pos.shape == (2, 2, 2) and float(arr.w_scale) == \
        pytest.approx(0.01)
    g_min = 1e-4
    g = lambda c: g_min + (1 - g_min) * c / 127               # noqa: E731
    assert arr.g_pos[0, 0].tolist() == pytest.approx([g(127), g(0)])
    assert arr.g_neg[0, 0].tolist() == pytest.approx([g(0), g(64)])
    assert arr.g_neg[1, 0].tolist() == pytest.approx([g(127), g(0)])
    assert arr.g_pos[1, 1].tolist() == [0.0, 0.0]               # padding


@pytest.mark.parametrize("name", ["sweep-parasitic.qwen1.5-4b",
                                  "sweep-design-a.rwkv6-3b"])
def test_weights_are_laid_out_as_the_port_reads_them(name):
    from reference import lm as R
    from repro_torch.config import ModelConfig
    from repro_torch.models.transformer import init_params

    cell = smoke.cell(name)
    ours = R.init_params(R.config(cell.config["model"]), SEED, CPU)
    port = init_params(ModelConfig(**cell.config["model"]), 0, device="meta")

    def shapes(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from shapes(v, path + (k,))
            else:
                yield path + (k,), tuple(v.shape)
    assert dict(shapes(ours)) == dict(shapes(port))
    again = R.init_params(R.config(cell.config["model"]), SEED, CPU)
    assert torch.equal(ours["embed"], again["embed"])


@pytest.mark.parametrize("name", ["sweep-parasitic.qwen1.5-4b",
                                  "sweep-design-a.rwkv6-3b"])
def test_reference_calibrates_as_the_port(name):
    """At smoke size the reference's clips and ADC limits are the port's
    to rounding, and so are the digital logits."""
    from harness import sweep as path
    from harness import traffic
    from reference import analog as A
    from reference import model as M
    from repro_torch.config import ModelConfig
    from repro_torch.serve import analog_engine as E

    cell = smoke.cell(name)
    rcfg = M.config(cell.config["model"])
    pcfg = ModelConfig(**cell.config["model"])
    params = M.init_params(rcfg, SEED, CPU)
    calib, tokens, _, _ = path._batches(cell.traffic, rcfg.vocab, SEED, CPU)
    _, desc = traffic.grid(cell.traffic)[-1]
    pack = E.calibrate_lm(pcfg, params, E.program_lm(
        pcfg, params, path.port_spec(desc), 77), calib)
    chip = M.Analog(rcfg, params, A.design(desc), 77)
    chip.calibrate(params, calib)
    for (site, i), clip in chip.clip.items():
        if site == M.HEAD:
            want = (pack.head_act, pack.head_lo[0], pack.head_hi[0])
        else:
            want = (pack.layer_act[site][i], pack.layer_lo[site][i, 0],
                    pack.layer_hi[site][i, 0])
        got = (clip,) + chip.range[site, i]
        for a, b in zip(got, want):
            assert float(a) == pytest.approx(float(b), rel=1e-4, abs=1e-4)
    lp, _ = E.forward(pcfg, params, tokens)
    lr, _, _ = M.forward(rcfg, params, tokens)
    assert torch.allclose(lp, lr, atol=1e-4)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        mods = set(_imports(path))
        assert not mods & set(common.FORBIDDEN), path
        if "reference" in path.relative_to(HERE).parts:
            assert "repro_torch" not in mods, path


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    # other test files in this process may have loaded JAX
    before = set(common.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch.fake", object())
    assert set(common.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert set(common.forbidden_modules()) - before == {"repro.fake"}


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run\n"
        "from harness import readings, sweep, trace, smoke\n"
        "from reference import lm\n"
        "import repro_torch.sweep, repro_torch.kernels.ops\n"
        "from harness import common\n"
        "print(common.forbidden_modules())\n"
    ) % (str(HERE), str(HERE.parent / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=_env())
    assert out.stdout.strip().splitlines()[-1] == "[]"
    code = ("import sys; sys.path[:0] = [%r]\nfrom reference import lm\n"
            "print(sorted(m for m in sys.modules if m.startswith('repro')))"
            ) % str(HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=_env())
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "sweep-design-a.rwkv6-3b", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=_env(),
        cwd=str(HERE.parent))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "sweep-design-a.rwkv6-3b", "--seed", str(SEED), "--seconds", "10",
         "--trace", "0"], capture_output=True, text=True, env=_env(),
        cwd=str(HERE.parent), timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert np.isfinite(line["metrics"]["point_s"]["value"])
