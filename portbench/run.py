"""The port's benchmark: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

Runs the cell named ``portbench/workloads/<cell>.json`` on one CUDA card
and prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``) and, last, ``check``: each number
compared with the plain reference beside its limit, which also close
standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics in ``BENCHMARK.json``, with ``--trace 1`` its
per-layer metrics, each read by ``portbench/metrics/<name>.py``.

``--control 1`` puts the plain reference, with the operands of its
arrays rounded to TF32, in the program's place (``portbench/reference``)
and prints the numbers it reads against the same limits; its
``correct`` is expected to be false.

Exits non-zero, printing no result, without a CUDA card, without the
port (``src/repro_torch``), or if JAX or the JAX package (``repro``) was
loaded.  The kernels' libraries build into ``build/repro_torch`` inside
the checkout at their first use, so only a checkout's first run builds
them."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from harness import common  # noqa: E402


def metric_defs(cell: str, kind: str) -> list:
    """``BENCHMARK.json``'s metrics of ``kind`` that ``cell`` reports."""
    bench = json.loads((common.ROOT / "BENCHMARK.json").read_text())
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def run_cell(cell: common.Cell, seed: int, seconds: float, trace: bool,
             device, *, control: bool = False, t_start=None,
             metrics_of=None):
    """Run ``cell`` once on ``device``: (result line, compared numbers
    beside their limits).  ``metrics_of(kind)`` lists the metric
    definitions to report (default: ``BENCHMARK.json``'s for the cell)."""
    import torch

    from harness import sweep

    path = {"sweep": sweep}[cell.traffic["path"]]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, numbers, record = path.run(
        cell, seed, seconds, trace, device,
        T_START if t_start is None else t_start, control=control)
    if metrics_of is None:
        def metrics_of(kind):
            return metric_defs(cell.name, kind)
    metrics = {}
    if trace:
        for m in metrics_of("per_layer"):
            v = common.load_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        t = record["trace"]
        if t is not None:
            result["device"]["busy_s"] = t.busy_s
            result["device"]["window_s"] = t.window_s
            result["breakdown"] = t.breakdown
    else:
        for m in metrics_of("end_to_end"):
            v = record["end_to_end"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    check = common.check_result(numbers, cell.limits)
    line = {"correct": bool(numbers) and common.passed(check), **result,
            "metrics": metrics}
    order = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown")
    return {k: line[k] for k in order if k in line}, check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = common.Cell.named(args.workload)
    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, check = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), device,
                             control=bool(args.control))
    bad = common.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    common.emit(result, check)
    return 0


if __name__ == "__main__":
    sys.exit(main())
