"""The sweep executor: group -> evaluate -> cache (counterpart of
``repro.sweep.executor``).

Execution model:

1. **Expand** the :class:`~repro_torch.sweep.spec.SweepSpec` grid into
   the flat design-point table.
2. **Resume**: points whose ``(evaluator signature, spec, protocol)``
   hash is already in the on-disk :class:`~repro_torch.sweep.results.
   SweepCache` are returned without recomputation.
3. **Group** the remaining points by *compile signature* — the spec with
   the evaluator's varying dynamic scalar fields (error magnitude, On/Off
   ratio, ``r_hat``, drift and fault ages) replaced by a placeholder.  The
   rules are the reference's, so every grid partitions exactly as there.
   In the reference a group is one jitted evaluation; in the port it is
   one materialized template and one programmed-codes cache entry shared
   by its points, which the evaluator loops over (``sweep.evaluate``).
4. **Dispatch** each group through the evaluator, optionally split over
   the ranks of a mesh (``repro_torch.sweep.dispatch``), timing
   wall-clock per group (split evenly over its points as ``wall_s``).
5. **Record** one :class:`~repro_torch.sweep.results.PointResult` per
   point and persist the cache.

The executor never inspects metric semantics — evaluators own that — so
accuracy sweeps, conductance audits, SNR probes, and energy tables all
run through this one path.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.sweep.results import (
    PointResult,
    SweepCache,
    SweepResults,
    point_key,
)
from repro_torch.sweep.spec import DesignPoint, SweepSpec, set_field

#: placeholder written into dynamic fields to form the compile signature;
#: never evaluated numerically (``evaluate.materialize`` substitutes each
#: point's own values).
_CANONICAL = 0.0


def compile_groups(
    points: List[Tuple[str, DesignPoint]],
    evaluator,
    all_points: Optional[List[DesignPoint]] = None,
) -> List[Tuple[object, Tuple[str, ...], List[Tuple[str, DesignPoint, Tuple[float, ...]]]]]:
    """Partition (cache_key, point) pairs into compile groups, as the
    reference does.

    A dynamic field is only placeholdered when its value varies across
    the sweep's points; a constant field stays in the template (the
    reference keeps it a concrete Python float rather than a traced
    float32 scalar, and the port groups identically).

    ``all_points`` is the FULL expanded design-point table; the varying
    set must come from it, not from the (possibly cache-thinned)
    ``points``, so that the grouping is a deterministic property of the
    sweep, never of which other points happened to be cached.
    """
    dyns = {id(pt): evaluator.dynamic_fields(pt.spec) for _, pt in points}
    seen: Dict[str, set] = {}
    basis = all_points if all_points is not None else [pt for _, pt in points]
    for pt in basis:
        for path, value in evaluator.dynamic_fields(pt.spec).items():
            seen.setdefault(path, set()).add(value)
    varying = {path for path, vals in seen.items() if len(vals) > 1}

    groups: Dict[Tuple[str, Tuple[str, ...]], Tuple[object, Tuple[str, ...], list]] = {}
    for key, pt in points:
        dyn = {p: v for p, v in dyns[id(pt)].items() if p in varying}
        dyn_names = tuple(sorted(dyn))
        template = pt.spec
        for name in dyn_names:
            template = set_field(template, name, _CANONICAL)
        gkey = (repr(template), dyn_names)
        if gkey not in groups:
            groups[gkey] = (template, dyn_names, [])
        groups[gkey][2].append((key, pt, tuple(dyn[n] for n in dyn_names)))
    return list(groups.values())


def run_sweep(
    sweep: SweepSpec,
    evaluator,
    *,
    cache_dir: Optional[str] = None,
    force: bool = False,
    mesh=None,
    verbose: bool = False,
) -> SweepResults:
    """Evaluate every design point of ``sweep``, resumable.

    ``cache_dir`` enables the on-disk cache (``<cache_dir>/sweeps/
    <name>.json``); ``force`` recomputes cached points; ``mesh`` (a 1-D
    ``data`` mesh, ``sweep.dispatch.sweep_mesh``) splits each group's
    points or trials over its ranks, and every rank gets every result
    (give each rank its own ``cache_dir``, or none); ``verbose`` prints
    the points left to run and their groups to stderr.
    """
    points = sweep.expand()
    protocol = sweep.point_protocol()
    sig = evaluator.signature()
    cache = SweepCache(cache_dir, sweep.name) if cache_dir else None

    results: List[PointResult] = []
    pending: List[Tuple[str, DesignPoint]] = []
    for pt in points:
        key = point_key(sig, pt, protocol)
        hit = cache.get(key) if (cache and not force) else None
        if hit is not None:
            results.append(
                PointResult.from_values(pt, hit.values, hit.wall_s,
                                        cached=True))
        else:
            pending.append((key, pt))

    groups = compile_groups(pending, evaluator, all_points=points)
    if verbose and pending:
        print(f"# sweep[{sweep.name}]: {len(pending)}/{len(points)} points "
              f"to run in {len(groups)} compile group(s)",
              file=sys.stderr, flush=True)

    for template, dyn_names, members in groups:
        rows = [m[2] for m in members]
        t0 = time.perf_counter()
        values = evaluator.evaluate_group(
            template, dyn_names, rows, sweep.trials, sweep.seed,
            sweep.test_n, mesh=mesh)
        wall = time.perf_counter() - t0
        if len(values) != len(members):
            raise ValueError(
                f"evaluator returned {len(values)} results for "
                f"{len(members)} points")
        per_point = wall / max(len(members), 1)
        for (key, pt, _), vals in zip(members, values):
            res = PointResult.from_values(pt, vals, per_point)
            results.append(res)
            if cache is not None:
                cache.put(key, res)

    if cache is not None:
        cache.save()
    return SweepResults(sweep, results)
