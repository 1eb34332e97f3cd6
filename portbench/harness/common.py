"""What every cell shares: the data files found by name, seeds, the
device's description, the import guard and the result line."""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict

import torch

BENCH = Path(__file__).resolve().parents[1]      # portbench/
ROOT = BENCH.parent                              # the checkout

#: top-level module names no run of the benchmark may hold: the JAX
#: package beside the port, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(kind: str, name: str) -> Dict[str, Any]:
    """``portbench/<kind>/<name>.json``."""
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """One workload with its configuration and traffic files."""

    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]

    @classmethod
    def named(cls, name: str) -> "Cell":
        wl = load("workloads", name)
        return cls(name=name, workload=wl, config=load("configs", wl["config"]),
                   traffic=load("traffic", wl["traffic"]))

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]


def fold(seed: int, tag: str) -> int:
    """An independent 63-bit seed from the run's ``--seed`` and a tag."""
    h = hashlib.blake2s(f"{int(seed)}/{tag}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") & 0x7FFFFFFFFFFFFFFF


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device: torch.device) -> Dict[str, Any]:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def load_reader(metric: str) -> Callable:
    """``portbench/metrics/<metric>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check_result(numbers: Dict[str, float],
                 limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number compared beside its limit (every limit is an upper
    one); a number missing from ``numbers`` reads as infinite."""
    return {k: {"value": float(numbers.get(k, float("inf"))),
                "limit": float(lim)} for k, lim in limits.items()}


def passed(check: Dict[str, Dict[str, float]]) -> bool:
    return all(v["value"] <= v["limit"] for v in check.values())


def emit(result: Dict[str, Any], check: Dict[str, Dict[str, float]]) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output,
    with the same numbers under ``check``, its last key."""
    for k, v in check.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["check"] = check
    print(json.dumps(line), flush=True)


class Log:
    """Seconds since the process started, printed to standard error at
    each phase of a run."""

    def __init__(self, t_start: float):
        self.t_start = t_start

    def __call__(self, what: str) -> None:
        import time

        print(f"portbench: {time.perf_counter() - self.t_start:9.3f} s "
              f"{what}", file=sys.stderr, flush=True)

