"""Sweep results: structured per-point records + resumable on-disk cache
(counterpart of ``repro.sweep.results``).

Every evaluated design point becomes a :class:`PointResult`; a sweep's
results persist as one JSON file per sweep name
(``<cache_dir>/sweeps/<name>.json``), keyed by a content hash of
``(evaluator signature, spec repr, trial protocol)``.  Re-running a sweep
— after a crash, an added axis value, or on another host with the cache
directory synced — recomputes only the missing points; a corrupt file
recomputes everything.  The port's evaluator signatures carry a
``torch-`` version tag and its spec ``repr`` differs from the
reference's, so a port result never answers for a reference point in a
shared cache directory (their random draws differ).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import tempfile
from typing import Any, Dict, List, Optional

from repro_torch.sweep.spec import DesignPoint, SweepSpec


def point_key(evaluator_sig: str, point: DesignPoint, protocol: str) -> str:
    """Stable cache identity of one evaluated design point.

    ``repr`` of an :class:`~repro_torch.core.analog.AnalogSpec` is
    deterministic (frozen dataclasses of primitives), so the hash covers
    every static field of the design point plus the weights/data hash
    carried in the evaluator signature.
    """
    blob = "\n".join([evaluator_sig, repr(point.spec), protocol])
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


@dataclasses.dataclass
class PointResult:
    """Metric values for one design point.

    ``values`` holds per-trial scalars for trial-based metrics, or a
    single entry (possibly a dict of named metrics) for deterministic
    ones; ``mean``/``std`` are populated only for scalar trials.
    """

    index: int
    tag: str
    coords: Dict[str, str]
    values: List[Any]
    mean: Optional[float]
    std: Optional[float]
    wall_s: float
    cached: bool = False

    @classmethod
    def from_values(cls, point: DesignPoint, values, wall_s: float,
                    cached: bool = False) -> "PointResult":
        vals = list(values) if isinstance(values, (list, tuple)) else [values]
        mean = std = None
        if vals and all(isinstance(v, (int, float)) for v in vals):
            finite = [float(v) for v in vals]
            mean = sum(finite) / len(finite)
            std = math.sqrt(sum((v - mean) ** 2 for v in finite) / len(finite))
        return cls(
            index=point.index,
            tag=point.tag,
            coords={p: str(v) for p, v in point.coords},
            values=vals,
            mean=mean,
            std=std,
            wall_s=wall_s,
            cached=cached,
        )

    def metric_mean(self, key: str) -> float:
        """Mean of one named metric over dict-valued trials.

        Evaluators with non-scalar per-trial state (``ServeEvaluator``:
        loss / top1 / decode_match per trial) store one dict per trial in
        ``values``; ``mean``/``std`` stay None and aggregation goes
        through here.
        """
        vals = [v[key] for v in self.values if isinstance(v, dict)]
        if not vals:
            raise KeyError(
                f"{self.tag} has no dict-valued trials with {key!r}")
        return sum(float(v) for v in vals) / len(vals)

    def metric_std(self, key: str) -> float:
        vals = [float(v[key]) for v in self.values if isinstance(v, dict)]
        if not vals:
            raise KeyError(
                f"{self.tag} has no dict-valued trials with {key!r}")
        mean = sum(vals) / len(vals)
        return math.sqrt(sum((v - mean) ** 2 for v in vals) / len(vals))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "PointResult":
        return cls(**d)


class SweepResults:
    """Ordered point results with tag lookup and small aggregations."""

    def __init__(self, sweep: SweepSpec, results: List[PointResult]):
        self.sweep = sweep
        self.results = sorted(results, key=lambda r: r.index)
        self._by_tag = {r.tag: r for r in self.results}

    def __iter__(self):
        return iter(self.results)

    def __len__(self):
        return len(self.results)

    def __getitem__(self, tag: str) -> PointResult:
        return self._by_tag[tag]

    def mean(self, tag: str) -> float:
        r = self[tag]
        if r.mean is None:
            raise ValueError(
                f"{tag} has non-scalar values; use metric() instead")
        return r.mean

    def metric(self, tag: str, key: str) -> float:
        """Trial-mean of one named metric of a dict-valued point."""
        return self[tag].metric_mean(key)

    def value(self, tag: str):
        return self[tag].values[0]

    @property
    def total_wall_s(self) -> float:
        return sum(r.wall_s for r in self.results if not r.cached)

    @property
    def n_cached(self) -> int:
        return sum(1 for r in self.results if r.cached)


class SweepCache:
    """One JSON file of finished point results per sweep name."""

    def __init__(self, cache_dir: str, name: str):
        self.path = os.path.join(cache_dir, "sweeps", f"{name}.json")
        self._data: Dict[str, dict] = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self._data = json.load(f)
            except (json.JSONDecodeError, OSError):
                self._data = {}   # corrupt cache: recompute everything

    def get(self, key: str) -> Optional[PointResult]:
        d = self._data.get(key)
        if d is None:
            return None
        r = PointResult.from_json(d)
        r.cached = True
        return r

    def put(self, key: str, result: PointResult) -> None:
        self._data[key] = result.to_json()

    def save(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path))
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)   # atomic: a crash never corrupts
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
