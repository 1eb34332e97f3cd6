"""The analyzer front door: run rules over sources, apply suppressions
(counterpart of ``repro.analysis.report``).

``analyze_source`` is the unit every caller builds on (tests feed it
fixture strings); ``analyze_paths`` walks real trees and is what
``python -m repro_torch.analysis`` invokes.  Python files go through the
AST rules of ``repro_torch.analysis.rules``; ``.cu`` and ``.cuh`` files
through ``repro_torch.analysis.csrc``.  Suppression (inline ``# repro:
ignore[rule]``, ``// repro: ignore[rule]`` in C++) is applied here, once,
so rules never need to know about it; baseline filtering is left to the
CLI because only the CI gate cares.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

from repro_torch.analysis import csrc
from repro_torch.analysis.findings import Finding, apply_suppressions
from repro_torch.analysis.walker import RULES, parse_module

# rules.py registers into RULES on import
from repro_torch.analysis import rules as _rules  # noqa: F401

_CSRC_SUFFIXES = (".cu", ".cuh")


def rule_ids() -> List[str]:
    return sorted([*RULES, csrc.RULE])


def analyze_source(source: str, path: str = "<string>",
                   only: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the rules over one source string; suppressions applied.  A
    ``.cu``/``.cuh`` path selects the C++ pass."""
    selected = _select(only)
    if path.endswith(_CSRC_SUFFIXES):
        if csrc.RULE not in selected:
            return []
        return sorted(csrc.check_source(source, path),
                      key=lambda f: (f.path, f.line, f.rule))
    try:
        mod = parse_module(source, path)
    except SyntaxError as e:
        return [Finding("syntax-error", path, e.lineno or 0, str(e.msg))]
    findings: List[Finding] = []
    for rid in selected:
        if rid in RULES:
            findings.extend(RULES[rid](mod))
    findings = apply_suppressions(findings, mod.lines)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def analyze_file(path: str,
                 only: Optional[Sequence[str]] = None) -> List[Finding]:
    with open(path) as f:
        source = f.read()
    return analyze_source(source, path, only=only)


def _wanted(name: str) -> bool:
    return name.endswith(".py") or name.endswith(_CSRC_SUFFIXES)


def analyze_paths(paths: Iterable[str],
                  only: Optional[Sequence[str]] = None) -> List[Finding]:
    """Analyze files and directory trees (``*.py``, ``*.cu``, ``*.cuh``;
    sorted, deduped)."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(root, n)
                             for n in sorted(names) if _wanted(n))
        elif _wanted(p):
            files.append(p)
        else:
            raise ValueError(
                f"not a .py, .cu or .cuh file or a directory: {p!r}")
    findings: List[Finding] = []
    for path in dict.fromkeys(files):
        findings.extend(analyze_file(path, only=only))
    return findings


def render(findings: Sequence[Finding]) -> str:
    if not findings:
        return "analysis clean: 0 findings"
    lines = [f.render() for f in findings]
    lines.append(f"{len(findings)} finding(s)")
    return "\n".join(lines)


def _select(only: Optional[Sequence[str]]) -> List[str]:
    if only is None:
        return rule_ids()
    unknown = sorted(set(only) - set(rule_ids()))
    if unknown:
        raise ValueError(
            f"unknown rule(s) {unknown!r}; available: {rule_ids()!r}")
    return sorted(dict.fromkeys(only))
