"""Heterogeneous per-site hardware profiles (counterpart of
``repro.hw.profile``): resolve each analog matmul site of a network to
its own :class:`~repro_torch.core.analog.AnalogSpec`.

A :class:`Profile` is an ordered rule list mapping *sites* (the stable
hook names ``wq``/``wk``/``wv``/``wo``, ``w_gate``/``w_up``/``w_down``,
``head``, ...) to specs.  Patterns match the site name, its class
(``"attn"``, ``"mlp"``) or the class-qualified name (``"attn.*"``); a rule
may be restricted to a half-open layer band; :data:`DIGITAL` keeps a site
off-array; the first matching rule wins.  :meth:`Profile.layer_bands`
groups layers into maximal runs with a constant site->rule map, and the
model loops over each band under its own specs.  :meth:`Profile.selectors`
lists the analog rules (the healer checks each one's ages), and
:meth:`Profile.with_field`/:meth:`Profile.field` set and read a field of
the specs a selector targets (the sweep engine's ``"attn:adc.bits"`` axis
paths, ``repro_torch.sweep.spec.set_field``).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
from typing import Iterator, List, Optional, Sequence, Tuple, Union

from repro_torch.core.analog import AnalogSpec

#: sentinel spec: keep this site off-array (exact digital matmul)
DIGITAL = "digital"

#: hook/site name -> site class (the pattern-matching namespace)
SITE_CLASS = {
    "wq": "attn", "wk": "attn", "wv": "attn", "wo": "attn",
    "xattn_wq": "attn", "xattn_wo": "attn",
    "w_gate": "mlp", "w_up": "mlp", "w_down": "mlp",
    "rwkv_wr": "rwkv", "rwkv_wk": "rwkv", "rwkv_wv": "rwkv",
    "rwkv_wg": "rwkv", "rwkv_wo": "rwkv", "rwkv_ck": "rwkv",
    "rwkv_cv": "rwkv", "rwkv_cr": "rwkv",
    "ssm_in": "ssm", "ssm_out": "ssm",
    "head": "head",
}

#: the lm_head site name (shared with ``repro_torch.serve.analog_engine.HEAD``)
HEAD = "head"

SpecOrDigital = Union[AnalogSpec, str]


def site_class(site: str) -> str:
    """Class of a site; unknown sites are their own class."""
    return SITE_CLASS.get(site, site)


def _check_spec(spec: SpecOrDigital, where: str) -> None:
    if not (isinstance(spec, AnalogSpec) or spec == DIGITAL):
        raise ValueError(
            f"{where} must be an AnalogSpec or the string {DIGITAL!r}, "
            f"got {spec!r}")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One resolver rule: ``pattern`` (+ optional layer band) → spec.

    ``name`` labels the rule; it defaults to the pattern with a trailing
    ``.*`` stripped, so ``Rule("attn.*", spec)`` answers to ``"attn"``.
    """

    pattern: str
    spec: SpecOrDigital
    layers: Optional[Tuple[int, int]] = None      # half-open [lo, hi)
    name: Optional[str] = None

    def __post_init__(self):
        _check_spec(self.spec, f"Rule({self.pattern!r}).spec")
        if self.layers is not None:
            lo, hi = self.layers
            if not (0 <= lo < hi):
                raise ValueError(
                    f"Rule({self.pattern!r}).layers must be a half-open "
                    f"band (lo, hi) with 0 <= lo < hi, got {self.layers}")
            object.__setattr__(self, "layers", (int(lo), int(hi)))

    @property
    def key(self) -> str:
        """The label this rule answers to."""
        if self.name is not None:
            return self.name
        p = self.pattern
        return p[:-2] if p.endswith(".*") else p

    def matches(self, site: str, layer: Optional[int]) -> bool:
        if self.layers is not None:
            if layer is None:
                return False
            lo, hi = self.layers
            if not (lo <= layer < hi):
                return False
        cls = site_class(site)
        return any(
            fnmatch.fnmatchcase(cand, self.pattern)
            for cand in (site, cls, f"{cls}.{site}")
        )


@dataclasses.dataclass(frozen=True)
class Profile:
    """Site-resolved hardware description: ordered rules + default spec.

    >>> Profile.by_class(attn=spec8, mlp=spec6, head=DIGITAL,
    ...                  default=spec8)

    ``default`` applies to sites no rule matches; it defaults to
    :data:`DIGITAL` ("everything not explicitly placed stays digital").
    """

    rules: Tuple[Rule, ...] = ()
    default: SpecOrDigital = DIGITAL

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        _check_spec(self.default, "Profile.default")

    # ---- constructors ----------------------------------------------------
    @classmethod
    def uniform(cls, spec: AnalogSpec) -> "Profile":
        """Every site on identical hardware — the pre-profile global spec."""
        if not isinstance(spec, AnalogSpec):
            raise ValueError(
                f"Profile.uniform expects an AnalogSpec, got {spec!r}")
        return cls(rules=(), default=spec)

    @classmethod
    def by_class(cls, *, default: SpecOrDigital = DIGITAL,
                 **class_specs: SpecOrDigital) -> "Profile":
        """One rule per site class: ``by_class(attn=a, mlp=b, head=DIGITAL)``."""
        rules = tuple(
            Rule(pattern=f"{c}.*" if c not in (HEAD,) else c, spec=s, name=c)
            for c, s in class_specs.items()
        )
        return cls(rules=rules, default=default)

    # ---- resolution ------------------------------------------------------
    def rule_index(self, site: str, layer: Optional[int] = None) -> int:
        """Index of the first matching rule, or -1 for the default.

        Resolution inspects only patterns and integer bands, never spec
        values.
        """
        for i, rule in enumerate(self.rules):
            if rule.matches(site, layer):
                return i
        return -1

    def resolve(self, site: str, layer: Optional[int] = None) -> SpecOrDigital:
        """The spec serving ``site`` (at ``layer``), or :data:`DIGITAL`."""
        i = self.rule_index(site, layer)
        return self.default if i < 0 else self.rules[i].spec

    def is_digital(self, site: str, layer: Optional[int] = None) -> bool:
        return not isinstance(self.resolve(site, layer), AnalogSpec)

    def first_analog(self, site: str, n_layers: int) -> Optional[AnalogSpec]:
        """The site's first analog resolution over ``n_layers``, if any.

        Array geometry is band-uniform per site (enforced at pack build),
        so this spec answers geometry questions — mapping scheme, slice
        count — for the whole stack.
        """
        for layer in range(n_layers):
            sp = self.resolve(site, layer)
            if isinstance(sp, AnalogSpec):
                return sp
        return None

    def layer_bands(self, sites: Sequence[str], n_layers: int,
                    ) -> Tuple[Tuple[int, int], ...]:
        """Maximal contiguous layer bands with a constant site→rule map.

        A profile without layer-band rules always yields the single band
        ``((0, n_layers),)`` — the uniform case, one loop over all layers.
        """
        if n_layers < 1:
            raise ValueError(f"n_layers must be >= 1, got {n_layers}")
        bands: List[Tuple[int, int]] = []
        start = 0
        prev = tuple(self.rule_index(s, 0) for s in sites)
        for layer in range(1, n_layers):
            cur = tuple(self.rule_index(s, layer) for s in sites)
            if cur != prev:
                bands.append((start, layer))
                start, prev = layer, cur
        bands.append((start, n_layers))
        return tuple(bands)

    def selectors(self) -> Iterator[Tuple[str, AnalogSpec]]:
        """(selector, spec) for every analog rule, in rule order, then
        ``("default", spec)`` if the default is analog."""
        for rule in self.rules:
            if isinstance(rule.spec, AnalogSpec):
                yield rule.key, rule.spec
        if isinstance(self.default, AnalogSpec):
            yield "default", self.default

    def _targets(self, selector: str) -> List[int]:
        return [i for i, r in enumerate(self.rules) if r.key == selector]

    def with_field(self, selector: str, path: str, value) -> "Profile":
        """Functionally set ``path`` on every spec the selector targets.

        ``selector`` is a rule key (``Rule.key``) or ``"default"``; the
        sweep layer spells this ``"<selector>:<field.path>"`` in axis
        paths (see ``repro_torch.sweep.spec.set_field``).
        """
        from repro_torch.sweep.spec import set_field as _set

        if selector == "default":
            if not isinstance(self.default, AnalogSpec):
                raise ValueError(
                    f"profile default is {DIGITAL!r}; cannot set "
                    f"{path!r} on it")
            return dataclasses.replace(
                self, default=_set(self.default, path, value))
        idx = self._targets(selector)
        if not idx:
            raise ValueError(
                f"no profile rule answers to selector {selector!r}; "
                f"known selectors: {[r.key for r in self.rules] + ['default']}")
        rules = list(self.rules)
        for i in idx:
            if not isinstance(rules[i].spec, AnalogSpec):
                raise ValueError(
                    f"rule {rules[i].pattern!r} (selector {selector!r}) is "
                    f"{DIGITAL!r}; cannot set {path!r} on it")
            rules[i] = dataclasses.replace(
                rules[i], spec=_set(rules[i].spec, path, value))
        return dataclasses.replace(self, rules=tuple(rules))

    def field(self, selector: str, path: str):
        """Read ``path`` from the selector's spec (first target wins)."""
        from repro_torch.sweep.spec import get_field as _get

        if selector == "default":
            spec = self.default
        else:
            idx = self._targets(selector)
            if not idx:
                raise ValueError(
                    f"no profile rule answers to selector {selector!r}")
            spec = self.rules[idx[0]].spec
        if not isinstance(spec, AnalogSpec):
            raise ValueError(
                f"selector {selector!r} resolves to {DIGITAL!r}; it has "
                f"no field {path!r}")
        return _get(spec, path)

    # ---- identity --------------------------------------------------------
    def signature(self) -> str:
        """Canonical identity for cache keys and compile-group keys."""
        blob = repr(self)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def as_profile(spec: Union[AnalogSpec, Profile]) -> Profile:
    """Accept the legacy global-spec API: wrap an AnalogSpec uniformly."""
    if isinstance(spec, Profile):
        return spec
    if isinstance(spec, AnalogSpec):
        return Profile.uniform(spec)
    raise ValueError(
        f"expected an AnalogSpec or hw.Profile, got {type(spec).__name__}: "
        f"{spec!r}")


# ---------------------------------------------------------------------------
# per-band site specs (the static payload the model layer threads)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SiteSpecs:
    """Frozen site→spec mapping for one layer band (hashable, ordered)."""

    items: Tuple[Tuple[str, AnalogSpec], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "items", tuple(self.items))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.items)

    def __contains__(self, name: str) -> bool:
        return any(n == name for n, _ in self.items)

    def get(self, name: str) -> Optional[AnalogSpec]:
        for n, s in self.items:
            if n == name:
                return s
        return None

    def spec_for(self, name: str) -> AnalogSpec:
        s = self.get(name)
        if s is None:
            raise KeyError(
                f"site {name!r} has no analog spec in this band; "
                f"analog sites: {list(self.names)}")
        return s


#: AnalogSpec fields that shape the programmed conductance stacks.  Sites
#: are stacked over *all* layers (one array per site), so a site's
#: resolved specs may differ across layer bands only in fields that leave
#: the stack's shape and dtype unchanged (ADC style/bits, error model,
#: on_off_ratio, input bits, ...).  These fields must agree:
GEOMETRY_FIELDS = (
    "mapping.scheme", "mapping.weight_bits", "mapping.bits_per_cell",
    "mapping.unit_column", "max_rows", "compute_dtype",
)


def geometry_key(spec: AnalogSpec) -> Tuple:
    """The array-geometry identity of a spec."""
    m = spec.mapping
    return (m.scheme, m.weight_bits, m.bits_per_cell, m.unit_column,
            spec.max_rows, str(spec.compute_dtype))


def fused_site_classes(
    profile: Profile,
    sites: Sequence[str],
    n_layers: int,
) -> "dict[Tuple, List[str]]":
    """Group a profile's analog sites by fused-kernel identity.

    Keys are :func:`repro_torch.core.analog.fuse_signature` tuples and
    values the sorted site names that share one.  Sites resolving digital
    everywhere, or to specs that refuse to fuse (``fused == "off"``,
    digital-accum parasitics, uncalibrated ADC, ...), never appear.
    """
    from repro_torch.core.analog import fuse_signature

    groups: "dict[Tuple, List[str]]" = {}
    for site in sites:
        sigs = set()
        for lo, _hi in profile.layer_bands((site,), n_layers):
            spec = profile.resolve(site, lo)
            if isinstance(spec, AnalogSpec):
                sig = fuse_signature(spec)
                if sig is not None:
                    sigs.add(sig)
        for sig in sigs:
            groups.setdefault(sig, []).append(site)
    return {sig: sorted(names) for sig, names in sorted(groups.items())}


def check_band_geometry(site: str, specs: Sequence[AnalogSpec]) -> None:
    """Raise if a site's per-band specs disagree on array geometry."""
    keys = {geometry_key(s) for s in specs}
    if len(keys) > 1:
        raise ValueError(
            f"site {site!r} resolves to specs with different array "
            f"geometry across layer bands; the fields {GEOMETRY_FIELDS} "
            f"must agree for a site (its conductance stack is one scanned "
            f"array), got geometries {sorted(keys)}")
