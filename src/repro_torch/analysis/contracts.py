"""Compile contracts: declared budgets, checked for real (counterpart of
``repro.analysis.contracts``).

The reference pins compilation structure: "the Fig. 19 ``r_hat`` axis is
ONE compile group", "the decode step compiles once across a ragged
trace".  The port keeps the declarations (:class:`CompileContract`, its
fields and its :class:`~repro_torch.analysis.findings.Finding` currency,
rule ``compile-contract``) and checks them at the same two levels:

* **static** — expand the contract's sweep grid and hold the port
  executor's :func:`~repro_torch.sweep.executor.compile_groups` partition
  to the declared group budget and traced field names, exactly as the
  reference does;
* **trace** — run the port's real entry points and count what "compile"
  means here.  PyTorch compiles nothing per call; what the port builds
  and fixes is:

  - ``nvcc`` builds (:class:`compile_counter`, over
    ``kernels.build.BUILDS``): zero once the libraries exist;
  - the programmed-codes cache of a sweep evaluator
    (:func:`programmed_cache_size`): one entry per compile group, as the
    reference's jit cache holds one signature;
  - the kernels each decode step and each prefill group launches
    (:class:`step_launches`): the same multiset every step, the invariant
    a CUDA graph of the step relies on.

The reference's jaxpr-constant check has no jaxpr to read here; its
question — does a point read a traced field's value from its row or
silently from the template? — is asked by
:func:`template_leak_violations`, which plants sentinels in the template
and runs the point.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding


class compile_counter:
    """Counts ``nvcc`` builds (``kernels.build.BUILDS``) inside a ``with``
    block: the port's backend compiles.  Process-wide, like the
    reference's XLA compile listener."""

    def __enter__(self) -> "compile_counter":
        from repro_torch.kernels import build

        self._start = build.BUILDS
        return self

    def __exit__(self, *exc) -> None:
        return None

    @property
    def count(self) -> int:
        from repro_torch.kernels import build

        return build.BUILDS - self._start


def programmed_cache_size(evaluator) -> int:
    """Entries of a sweep evaluator's programmed-codes cache
    (``ClassifierEvaluator._pm_cache``, ``ServeEvaluator._codes_cache``):
    the port's "compiled signatures", one per compile group's mapping."""
    for name in ("_pm_cache", "_codes_cache"):
        cache = getattr(evaluator, name, None)
        if cache is not None:
            return len(cache)
    raise ValueError(
        f"{evaluator!r} exposes no programmed-codes cache; contract "
        f"entries must be ClassifierEvaluator or ServeEvaluator instances")


def launch_counts(device_type: str) -> Dict[str, int]:
    """The kernel counts a run on ``device_type`` advances: launches on a
    card (``kernels.fused.LAUNCHES``), and on the CPU the calls that
    would have launched (``kernels.ops.ROUTE_CALLS``' ``"cpu"`` route)."""
    from repro_torch.kernels import fused, ops

    if device_type == "cuda":
        return dict(fused.LAUNCHES)
    return {k: ops.ROUTE_CALLS.get((k, "cpu"), 0) for k in fused.LAUNCHES}


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in sorted(after)
            if after[k] != before.get(k, 0)}


class step_launches:
    """Record, for every decode step and every prefill group a runtime
    runs inside the ``with`` block, the multiset of kernel launches.

    ``decode`` is a list of ``{kernel: launches}``, one per decode step;
    ``prefill`` maps each prefill group key — ``(bucket, gang size)`` for
    :class:`~repro_torch.serve.ServeRuntime`, ``(cached ctx, suffix
    bucket, gang size)`` for :class:`~repro_torch.serve.PagedServeRuntime`
    (the reference's ``_prefill_fns`` keys) — to the multisets of its
    calls.  On a card the counts are launches; on the CPU, the calls that
    would launch (:func:`launch_counts`)."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.decode: List[Dict[str, int]] = []
        self.prefill: Dict[Tuple, List[Dict[str, int]]] = \
            collections.defaultdict(list)

    def _wrap(self, name: str, record: Callable) -> None:
        rt = self.runtime
        inner = getattr(rt, name)
        dev = rt.device.type

        def wrapped(*args, **kw):
            before = launch_counts(dev)
            out = inner(*args, **kw)
            record(args, _delta(launch_counts(dev), before))
            return out

        setattr(rt, name, wrapped)

    def __enter__(self) -> "step_launches":
        rt = self.runtime
        self._wrap("_run_decode", lambda a, d: self.decode.append(d))
        if hasattr(rt, "_paged_prefill"):
            self._wrap("_paged_prefill", lambda a, d: self.prefill[
                (int(a[0]), int(a[1].shape[1]), int(a[1].shape[0]))]
                .append(d))
        else:
            self._wrap("_prefill", lambda a, d: self.prefill[
                (int(a[0].shape[1]), int(a[0].shape[0]))].append(d))
        return self

    def __exit__(self, *exc) -> None:
        for name in ("_run_decode", "_paged_prefill", "_prefill"):
            self.runtime.__dict__.pop(name, None)

    def decode_violations(self, label: str,
                          expect: Optional[Dict[str, int]] = None
                          ) -> List[str]:
        """Decode steps that launch another multiset than the first (or
        than ``expect``)."""
        if not self.decode:
            return [f"{label}: no decode step ran"]
        want = expect if expect is not None else self.decode[0]
        bad = [i for i, d in enumerate(self.decode) if d != want]
        if not bad:
            return []
        return [f"{label}: {len(bad)} of {len(self.decode)} decode steps "
                f"launch other kernels than {want} (step {bad[0]}: "
                f"{self.decode[bad[0]]})"]

    def prefill_violations(self, label: str) -> List[str]:
        """Prefill group keys whose calls launch different multisets."""
        out = [] if self.prefill else [f"{label}: no prefill ran"]
        for key, calls in sorted(self.prefill.items()):
            if any(c != calls[0] for c in calls):
                out.append(f"{label}: prefill group {key} launches "
                           f"{len(set(map(repr, calls)))} different "
                           f"multisets over {len(calls)} calls")
        return out


@dataclasses.dataclass(frozen=True)
class CompileContract:
    """One declared compilation budget for an entry point (the
    reference's fields).

    Static fields — require ``sweep`` + ``evaluator``: ``max_groups`` /
    ``min_groups`` bound the :func:`compile_groups` partition of the
    expanded grid; ``expect_dynamic`` is the set of allowed per-group
    traced-field name tuples; ``require_dynamic`` names fields that must be
    dynamic in at least one group.

    Trace fields: ``run`` is the workload and may return a list of
    violation strings; ``warmup`` runs before counting starts; ``entries``
    returns the sweep evaluators whose programmed-codes caches are summed
    after ``run``; ``max_compiles`` bounds that sum, or the ``nvcc``
    builds during ``run`` when no ``entries`` are named (``None`` skips
    counting).
    """

    name: str
    description: str = ""
    # static level
    sweep: Optional[Any] = None                  # SweepSpec
    evaluator: Optional[Callable[[], Any]] = None
    max_groups: Optional[int] = None
    min_groups: Optional[int] = None
    expect_dynamic: Optional[Tuple[Tuple[str, ...], ...]] = None
    require_dynamic: Tuple[str, ...] = ()
    # trace level
    run: Optional[Callable[[], Any]] = None
    warmup: Optional[Callable[[], Any]] = None
    entries: Optional[Callable[[], Sequence[Any]]] = None
    max_compiles: Optional[int] = None

    def declares_static(self) -> bool:
        return self.sweep is not None

    def declares_trace(self) -> bool:
        return self.run is not None


def _static_findings(c: CompileContract) -> List[Finding]:
    from repro_torch.sweep.executor import compile_groups
    from repro_torch.sweep.results import point_key

    ev = c.evaluator()
    pts = c.sweep.expand()
    proto = c.sweep.point_protocol()
    groups = compile_groups(
        [(point_key(ev.signature(), p, proto), p) for p in pts], ev)
    out: List[Finding] = []
    where = f"contract {c.name!r}"
    if c.max_groups is not None and len(groups) > c.max_groups:
        out.append(Finding(
            "compile-contract", where, 0,
            f"{len(pts)}-point grid partitions into {len(groups)} compile "
            f"groups, budget is {c.max_groups} — an axis declared traced "
            f"is recompiling per value"))
    if c.min_groups is not None and len(groups) < c.min_groups:
        out.append(Finding(
            "compile-contract", where, 0,
            f"grid partitions into {len(groups)} compile groups, expected "
            f"at least {c.min_groups} — a static program-structure split "
            f"(e.g. parasitics on/off) is being traced away"))
    dyn_seen = {dyn_names for _, dyn_names, _ in groups}
    if c.expect_dynamic is not None:
        allowed = {tuple(t) for t in c.expect_dynamic}
        for names in sorted(dyn_seen):
            if names not in allowed:
                out.append(Finding(
                    "compile-contract", where, 0,
                    f"group traces fields {names!r}, allowed sets are "
                    f"{sorted(allowed)!r}"))
    for path in c.require_dynamic:
        if not any(path in names for names in dyn_seen):
            out.append(Finding(
                "compile-contract", where, 0,
                f"field {path!r} is declared traced but appears in no "
                f"group's dynamic names — its axis recompiles per value"))
    return out


def _trace_findings(c: CompileContract) -> List[Finding]:
    where = f"contract {c.name!r}"
    out: List[Finding] = []
    if c.warmup is not None:
        c.warmup()
    with compile_counter() as counter:
        violations = c.run() if c.run is not None else None
    if isinstance(violations, (list, tuple)):
        out.extend(Finding("compile-contract", where, 0, str(v))
                   for v in violations)
    if c.max_compiles is not None:
        if c.entries is not None:
            n = sum(programmed_cache_size(ev) for ev in c.entries())
            kind = "evaluator programmed-codes caches hold"
        else:
            n = counter.count
            kind = "workload ran nvcc"
        if n > c.max_compiles:
            out.append(Finding(
                "compile-contract", where, 0,
                f"{kind} {n} compilations, budget is {c.max_compiles}"))
    return out


def check_contract(c: CompileContract,
                   level: str = "static") -> List[Finding]:
    """Verify one contract; returns violations (empty = holds)."""
    if level not in ("static", "trace"):
        raise ValueError(f"level must be 'static' or 'trace', got {level!r}")
    if level == "static":
        if not c.declares_static():
            return []
        return _static_findings(c)
    if not c.declares_trace():
        return []
    return _trace_findings(c)


def check_contracts(contracts: Sequence[CompileContract],
                    level: str = "static") -> List[Finding]:
    out: List[Finding] = []
    for c in contracts:
        out.extend(check_contract(c, level))
    return out


# ---------------------------------------------------------------------------
# dynamic fields flow from the row, never from the template
# ---------------------------------------------------------------------------

#: sentinel magnitudes for template-leak checks: distinctive, finite, and
#: never arising from shape arithmetic (the reference's)
TRACE_SENTINELS = (0.0123456789, 0.0987654321, 0.0246813579, 0.0135792468)


def _floats(obj, path: str = ""):
    """``(path, value)`` of every float field of a spec tree."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _floats(getattr(obj, f.name),
                               f"{path}.{f.name}" if path else f.name)
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _floats(v, f"{path}[{i}]")
    elif isinstance(obj, float):
        yield path, obj


def _same(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def template_leak_violations(fn: Callable, template, row: Dict[str, Any],
                             sentinels: Sequence[float],
                             label: str = "") -> List[str]:
    """Run one point with sentinels planted in the template.

    ``fn(template, row)`` materializes the point from ``template`` and its
    dynamic values ``row`` (``{field path: value}``) and returns
    ``(materialized spec, result)``.  The fields ``row`` sets are first
    overwritten in the template with ``sentinels``, in order.  A violation
    is a materialized field still holding a sentinel (the point read the
    template, not its row) or a result that differs from the same point
    built on the clean template."""
    from repro_torch.sweep.spec import set_field

    name = label or getattr(fn, "__name__", "entry point")
    if len(sentinels) < len(row):
        raise ValueError(f"{len(row)} fields need as many sentinels, got "
                         f"{len(sentinels)}")
    planted = template
    for path, s in zip(row, sentinels):
        planted = set_field(planted, path, s)
    spec_p, res_p = fn(planted, row)
    _, res_c = fn(template, row)
    out = []
    for path, v in _floats(spec_p):
        for s in sentinels[:len(row)]:
            if abs(v - s) < 1e-12:
                out.append(f"{name}: materialized field {path} still holds "
                           f"the template's sentinel {s} — the point reads "
                           f"the template, not its row")
    if not _same(res_p, res_c):
        out.append(f"{name}: the point's result moves with the template's "
                   f"values of its dynamic fields ({res_p!r} on the "
                   f"sentinel template, {res_c!r} on the clean one)")
    return out
