"""The one general generator: every mix is a data file under
``portbench/traffic/`` read here.

A sweep mix declares a design grid, its trials and the sizes of the
token batches the evaluator gets; every seed draws the same sizes, with
its own token ids and trial seeds, so a seed changes the numbers and not
the amount of work."""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Tuple


def grid(mix: Dict[str, Any]) -> List[Tuple[str, Dict[str, Any]]]:
    """The sweep's design points in order: (tag, design object), the base
    design with each axis's value set, axes varying last-fastest."""
    axes = mix.get("axes", [])
    points = []
    for values in itertools.product(*(a["values"] for a in axes)):
        desc = {k: v for k, v in mix["base"].items() if k != "fields"}
        fields = dict(mix["base"].get("fields", {}))
        err = dict(desc.get("error") or {})
        tag = []
        for axis, value in zip(axes, values):
            path = axis["path"]
            if path.startswith("error."):
                err[path[len("error."):]] = value
            else:
                fields[path] = value
            tag.append(f"{axis.get('short', path)}{value:g}"
                       if isinstance(value, float) else
                       f"{axis.get('short', path)}{value}")
        if err:
            desc["error"] = err
        desc["fields"] = fields
        points.append(("_".join(tag) or "base", desc))
    return points
