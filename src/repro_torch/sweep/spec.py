"""Declarative design-space sweeps (paper Figs. 6-19, Tables 3-4);
counterpart of ``repro.sweep.spec``.

The paper's experimental method is one loop repeated thirteen times:
take a trained network, sweep a grid of analog design points (mapping
scheme x cell-error magnitude x ADC resolution x array size x parasitic
level), and average the metric over repeated programming trials.  A
:class:`SweepSpec` states that grid declaratively — a base
:class:`~repro_torch.core.analog.AnalogSpec` plus :class:`Axis` entries
naming dotted field paths — and :meth:`SweepSpec.expand` flattens it into
the design-point table the executor (``repro_torch.sweep.executor``)
groups and caches.

Two axis flavors:

* a single dotted path (``Axis("adc.bits", (5, 6, 7, 8))``) — a normal
  cartesian factor;
* a *zipped* tuple of paths
  (``Axis(("mapping.scheme", "input_accum"),
  (("differential", "analog"), ("offset", "digital")))``) — fields that
  co-vary, e.g. the paper always pairs offset subtraction with digital
  input accumulation.

Explicit point lists (the named designs A-E of Table 3/4) bypass the
grid via :meth:`SweepSpec.from_points`.  Tags, coords and protocols are
the reference's, string for string.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.analog import AnalogSpec


def _profile_path(path: str) -> Tuple[str, str]:
    selector, sep, rest = path.partition(":")
    if not sep or not rest:
        raise ValueError(
            f"profile field paths are '<selector>:<field.path>' "
            f"(e.g. 'attn:adc.bits'), got {path!r}")
    return selector, rest


def set_field(obj, path: str, value):
    """Functionally set a dotted dataclass field path, e.g. ``mapping.scheme``.

    On a :class:`repro_torch.hw.Profile`, paths are spelled
    ``"<selector>:<field.path>"`` (e.g. ``"attn:adc.bits"``): the selector
    names the profile rule(s) whose spec the field is set on (``"default"``
    for the fallback spec).
    """
    from repro_torch.hw.profile import Profile

    if isinstance(obj, Profile):
        return obj.with_field(*_profile_path(path), value)
    head, _, rest = path.partition(".")
    if rest:
        return dataclasses.replace(
            obj, **{head: set_field(getattr(obj, head), rest, value)})
    return dataclasses.replace(obj, **{head: value})


def get_field(obj, path: str):
    """Read a dotted field path (``"<selector>:<path>"`` on a Profile)."""
    from repro_torch.hw.profile import Profile

    if isinstance(obj, Profile):
        return obj.field(*_profile_path(path))
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


def short_value(v) -> str:
    """Compact human-readable form of an axis value for point tags."""
    if v is None:
        return "None"
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        kind = getattr(v, "kind", None)
        if kind is not None:  # ErrorModel
            alpha = getattr(v, "alpha", 0.0)
            return kind if kind in ("none", "sonos") else f"{kind}:{alpha:g}"
        return type(v).__name__
    if isinstance(v, float):
        return "inf" if math.isinf(v) else f"{v:g}"
    return str(v)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One swept factor: a field path (or zipped paths) and its values."""

    path: Any                      # str | tuple[str, ...]
    values: Tuple[Any, ...]
    labels: Optional[Tuple[str, ...]] = None   # overrides tag fragments

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))
        if self.labels is not None:
            object.__setattr__(self, "labels", tuple(self.labels))
            if len(self.labels) != len(self.values):
                raise ValueError(
                    f"axis {self.path!r}: {len(self.labels)} labels for "
                    f"{len(self.values)} values")

    @property
    def paths(self) -> Tuple[str, ...]:
        return (self.path,) if isinstance(self.path, str) else tuple(self.path)

    def entries(self) -> List[Tuple[Dict[str, Any], str]]:
        """(assignments, tag fragment) per value."""
        out = []
        for i, v in enumerate(self.values):
            vs = (v,) if isinstance(self.path, str) else tuple(v)
            if len(vs) != len(self.paths):
                raise ValueError(
                    f"zipped axis {self.path!r} expects {len(self.paths)} "
                    f"values per entry, got {v!r}")
            assign = dict(zip(self.paths, vs))
            if self.labels is not None:
                frag = self.labels[i]
            else:
                name = self.paths[0].rsplit(".", 1)[-1]
                frag = f"{name}{short_value(vs[0])}"
            out.append((assign, frag))
        return out


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One row of the expanded design-point table."""

    index: int
    tag: str
    spec: AnalogSpec
    coords: Tuple[Tuple[str, Any], ...]   # (path, value) in axis order

    def coord(self, path: str):
        for p, v in self.coords:
            if p == path:
                return v
        raise KeyError(path)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A named design-space sweep: grid x trials x evaluation protocol.

    ``trials`` is the paper's repeated-programming-trial count (Sec. 5's
    10-trial protocol); ``seed`` derives the per-trial seeds
    (``evaluate.trial_keys``).  ``test_n`` optionally subsamples the test
    set (Sec. 4.3's 1000-image subset trick for expensive parasitic
    points).

    ``base`` is an :class:`~repro_torch.core.analog.AnalogSpec` or — for
    heterogeneous serving sweeps — a :class:`repro_torch.hw.Profile`, in
    which case axis paths are spelled ``"<selector>:<field.path>"``
    (``Axis("mlp:adc.bits", (4, 6, 8))``).
    """

    name: str
    base: Any = dataclasses.field(default_factory=AnalogSpec)
    axes: Tuple[Axis, ...] = ()
    explicit: Optional[Tuple[Tuple[str, AnalogSpec], ...]] = None
    trials: int = 5
    seed: int = 1234
    test_n: Optional[int] = None

    @classmethod
    def from_points(cls, name: str, points: Iterable[Tuple[str, AnalogSpec]],
                    **kw) -> "SweepSpec":
        return cls(name=name, explicit=tuple(points), **kw)

    def expand(self) -> List[DesignPoint]:
        """Flatten the declared grid into the design-point table."""
        if self.explicit is not None:
            return [
                DesignPoint(index=i, tag=tag, spec=spec,
                            coords=(("point", tag),))
                for i, (tag, spec) in enumerate(self.explicit)
            ]
        points: List[DesignPoint] = []
        per_axis = [ax.entries() for ax in self.axes]
        for i, combo in enumerate(itertools.product(*per_axis)):
            spec = self.base
            frags: List[str] = []
            coords: List[Tuple[str, Any]] = []
            for assign, frag in combo:
                for path, value in assign.items():
                    spec = set_field(spec, path, value)
                    coords.append((path, value))
                frags.append(frag)
            tag = "_".join(frags) if frags else "base"
            points.append(
                DesignPoint(index=i, tag=tag, spec=spec, coords=tuple(coords)))
        return points

    def point_protocol(self) -> str:
        """The evaluation-protocol part of a point's cache identity."""
        return f"trials={self.trials};seed={self.seed};test_n={self.test_n}"
