"""The benchmark's yardstick on the CPU: work counts against shapes worked
by hand, traffic and inputs that replay by seed, the contract of
``BENCHMARK.json`` and the data files it names."""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from harness import common, traffic, work  # noqa: E402
from harness import sweep as sweep_path  # noqa: E402

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_sweep_ops_by_hand():
    # per row 2 products + 3 adds + 1 product + 2 divisions (16 each);
    # per system one more division
    assert work.sweep_ops(1, 1) == 6 + 32 + 16
    assert work.sweep_ops(3, 854) == 3 * (854 * 38 + 16)


@pytest.mark.parametrize("m,p,rows,s,n,planes", [
    (4, 3, 854, 1, 2560, 1),       # a decode step's q projection
    (64, 6, 1152, 1, 2560, 1),     # w_down at 64 rows
    (2, 1, 64, 2, 96, 8),          # two slices, bit-serial planes
])
def test_b1_work_by_hand(m, p, rows, s, n, planes):
    n_bytes, n_flops = work.b1_work(m, p, rows, s, n, planes)
    weights = s * p * rows * n
    assert n_bytes == 4 * (m * p * rows + weights + m * n)
    assert n_flops == 2 * m * weights * planes


def test_b5_b6_work_by_hand():
    # B5: 6 arrays of (854, 2560), 3 plane batches of 1024 rows
    b, f = work.b5_work(6, 854, 2560, 3, 1024)
    assert b == 4 * (3 * 1024 * 854 + 6 * 854 * 2560 + 6 * 1024 * 2560)
    assert f == 6 * 1024 * 2560 * (854 * 38 + 16)
    # B6: 4 rows, 3 partitions of 854 rows, N 2560, 8 bits, both lines
    b, f = work.b6_work(4, 3, 854, 2560, 8)
    assert b == 4 * (4 * 3 * 854 + 2 * 3 * 854 * 2560 + 4 * 2560)
    systems = 2 * 8 * 4 * 3 * 2560
    assert f == systems * (854 * 38 + 16) + 3 * 8 * 4 * 3 * 2560


def test_bound_takes_the_larger_roofline():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 134e12) == pytest.approx(2.0)


def test_attention_flops_by_hand():
    # 3 new positions after 2 cached: visible 3, 4, 5 -> 12 positions
    assert work.attention_flops(1, 1, 1, 3, 2) == 4 * 12
    assert work.attention_flops(4, 20, 128, 1, 99) == 4 * 4 * 20 * 128 * 100


@pytest.mark.parametrize("name,n_points", [
    ("sweep-parasitic.qwen1.5-4b", 3), ("sweep-design-a.rwkv6-3b", 6)])
def test_grids(name, n_points):
    mix = common.Cell.named(name).traffic
    points = traffic.grid(mix)
    assert len(points) == n_points
    assert len({t for t, _ in points}) == n_points


def test_sweep_batches_replay_by_seed():
    mix = common.Cell.named("sweep-design-a.rwkv6-3b").traffic
    a = sweep_path._batches(mix, 1000, 2 ** 31 + 5, torch.device("cpu"))
    b = sweep_path._batches(mix, 1000, 2 ** 31 + 5, torch.device("cpu"))
    c = sweep_path._batches(mix, 1000, 2 ** 31 + 6, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    calib, tokens, targets, prompts = a
    assert calib.shape == (8, 32) and tokens.shape == (8, 32)
    assert torch.equal(prompts, tokens[:4, :8])
    assert torch.equal(targets[:, :-1], tokens[:, 1:])


def test_fold_takes_large_seeds():
    assert common.fold(2 ** 31 + 11, "weights") != common.fold(2 ** 31 + 12,
                                                               "weights")
    assert 0 <= common.fold(2 ** 40, "x") < 2 ** 63


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (HERE.parent / c["file"]).is_file()
        data = json.loads((HERE.parent / c["file"]).read_text())
        assert set(c["reduced"]) <= set(data["model"])
        assert set(data["published"]) == set(c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in configs
        assert len(w["why"]) <= 200
        wl = common.load("workloads", w["name"])
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        assert wl["why"] == w["why"]
    reports = {}
    for m in BENCH["end_to_end"]:
        assert m["bound"] <= 0.25
        for c in m.get("workloads", cells):
            reports.setdefault(c, set()).add(m["name"])
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        for c in m["workloads"]:
            assert m["moves"] in reports[c], (m["name"], c)
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert any(c in m["workloads"] for m in BENCH["per_layer"])
