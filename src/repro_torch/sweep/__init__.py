"""``repro_torch.sweep`` — the design-space sweep engine (counterpart of
``repro.sweep``).

A grid of analog design points is declared once and evaluated through
one cached, resumable path:

>>> from repro_torch.sweep import (Axis, SweepSpec, ClassifierEvaluator,
...                                run_sweep)
>>> sweep = SweepSpec(
...     name="onoff",
...     base=spec0,
...     axes=(Axis("mapping.on_off_ratio", (10.0, 100.0, float("inf"))),),
...     trials=5,
... )
>>> results = run_sweep(sweep, ClassifierEvaluator(layers, xca, xte, yte),
...                     cache_dir="sweep_cache")
>>> results.mean("on_off_ratio100")

The port loops over a compile group's points and trials in Python, with
integer seeds and port-tagged cache signatures (``sweep.evaluate``); on a
process group of several ranks ``run_sweep(mesh=sweep_mesh())`` splits
them over the ranks (``sweep.dispatch``).
"""

from repro_torch.sweep.dispatch import shard_leading, sweep_mesh
from repro_torch.sweep.evaluate import (
    ClassifierEvaluator,
    FunctionEvaluator,
    mapping_signature,
    materialize,
    serial_accuracy,
    trial_accuracy,
    trial_keys,
)
from repro_torch.sweep.executor import compile_groups, run_sweep
from repro_torch.sweep.results import (PointResult, SweepCache, SweepResults,
                                       point_key)
from repro_torch.sweep.serve_eval import ServeEvaluator, serve_serial_reference
from repro_torch.sweep.spec import (Axis, DesignPoint, SweepSpec, get_field,
                                    set_field)

__all__ = [
    "Axis",
    "ClassifierEvaluator",
    "DesignPoint",
    "FunctionEvaluator",
    "PointResult",
    "ServeEvaluator",
    "SweepCache",
    "SweepResults",
    "SweepSpec",
    "compile_groups",
    "get_field",
    "mapping_signature",
    "materialize",
    "point_key",
    "run_sweep",
    "serial_accuracy",
    "serve_serial_reference",
    "set_field",
    "shard_leading",
    "sweep_mesh",
    "trial_accuracy",
    "trial_keys",
]
