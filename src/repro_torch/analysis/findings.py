"""Findings, inline suppressions, and the committed baseline (counterpart
of ``repro.analysis.findings``).

A :class:`Finding` is the analyzer's one output currency: every lint
pass and every contract check reports ``Finding(rule, path, line, msg)``
rows, the CLI renders them, and CI gates on the set that is neither

* **suppressed** — the flagged source line carries an inline
  ``# repro: ignore[<rule>]`` marker (scoped to that rule; use it for
  reviewed, deliberate exceptions), nor
* **baselined** — the ``(rule, path, msg)`` triple appears in the
  committed baseline file (line numbers are excluded from the identity
  so unrelated edits above a baselined finding do not un-baseline it).

A copy of ``repro.analysis.findings`` (the port imports nothing of the
reference): the inline marker and the baseline's JSON rows are the same,
so either package reads the other's baseline.  The port's baseline
(``repro_torch/analysis/baseline.json``) ships empty, and the CI gate
(``python -m repro_torch.analysis --ci``) keeps it that way.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Sequence, Tuple

#: inline suppression: ``some_code()  # repro: ignore[rule-name]``
_IGNORE = re.compile(r"#\s*repro:\s*ignore\[([a-z0-9_,\- ]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result, lint or contract.

    ``line`` is 1-indexed into ``path`` for lint findings; contract
    findings (no single source line) use line 0 and a path naming the
    contract's declaring module.
    """

    rule: str
    path: str
    line: int
    msg: str

    def key(self) -> Tuple[str, str, str]:
        """Line-insensitive identity used for baseline matching."""
        return (self.rule, self.path, self.msg)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


def suppressed_rules(source_line: str) -> frozenset:
    """Rule names suppressed by inline markers on ``source_line``."""
    rules: set = set()
    for m in _IGNORE.finditer(source_line):
        rules.update(r.strip() for r in m.group(1).split(","))
    return frozenset(rules)


def apply_suppressions(findings: Sequence[Finding],
                       source_lines: Sequence[str]) -> List[Finding]:
    """Drop findings whose flagged line carries ``# repro: ignore[rule]``."""
    kept = []
    for f in findings:
        if 1 <= f.line <= len(source_lines):
            if f.rule in suppressed_rules(source_lines[f.line - 1]):
                continue
        kept.append(f)
    return kept


class Baseline:
    """The committed set of grandfathered findings (normally empty).

    Stored as a JSON list of ``{"rule", "path", "msg"}`` rows; matching
    ignores line numbers so the baseline survives unrelated edits.
    """

    def __init__(self, entries: Sequence[Dict[str, str]] = ()):
        self._keys = {(e["rule"], e["path"], e["msg"]) for e in entries}

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, finding: Finding) -> bool:
        return finding.key() in self._keys

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return cls()
        if not isinstance(data, list):
            raise ValueError(
                f"baseline {path!r} must be a JSON list of "
                f"{{rule, path, msg}} rows, got {type(data).__name__}")
        return cls(data)

    @staticmethod
    def write(path: str, findings: Sequence[Finding]) -> None:
        rows = [{"rule": f.rule, "path": f.path, "msg": f.msg}
                for f in sorted(findings, key=lambda f: f.key())]
        with open(path, "w") as fh:
            json.dump(rows, fh, indent=2)
            fh.write("\n")

    def filter(self, findings: Sequence[Finding]) -> List[Finding]:
        """The findings NOT covered by this baseline (the CI gate set)."""
        return [f for f in findings if f not in self]
