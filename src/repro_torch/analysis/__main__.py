"""The port's analyzer CLI: hazard lint + contracts, CI-gateable.

Runs the ``repro_torch.analysis`` rules over source trees (Python, and
the CUDA sources under ``csrc/``) and checks the port's declared
:class:`~repro_torch.analysis.CompileContract` suite.  Findings that are
neither inline-suppressed (``# repro: ignore[rule]``) nor in the
committed baseline (``repro_torch/analysis/baseline.json``) fail
``--ci`` with a nonzero exit::

    PYTHONPATH=src python -m repro_torch.analysis --ci

lints ``src/repro_torch`` and checks the static contracts (sweep
grouping; no device work).  ``--contracts trace`` also serves the
contract traces and runs the sweep contracts, on the card unless
``--device cpu`` asks for the CPU.

Other entry points::

    python -m repro_torch.analysis src/repro_torch/serve   # lint a tree
    python -m repro_torch.analysis --rules scalar-div ...  # one rule only
    python -m repro_torch.analysis --list-rules
    python -m repro_torch.analysis --write-baseline        # grandfather
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis import (
    Baseline,
    analyze_paths,
    check_contracts,
    render,
    rule_ids,
)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_PATHS = [PACKAGE]
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="PyTorch/CUDA hazard lint + contract checker")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or trees to lint (default: src/repro_torch)")
    ap.add_argument("--ci", action="store_true",
                    help="gate mode: lint + static contracts, exit nonzero "
                         "on any non-baselined finding")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON path (default: %(default)s)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current lint findings to the baseline and "
                         "exit (grandfathering — prefer fixing)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset to run")
    ap.add_argument("--contracts", choices=("none", "static", "trace"),
                    default=None,
                    help="contract level to check (default: static under "
                         "--ci, none otherwise; trace runs the port's "
                         "serving and sweep entry points)")
    ap.add_argument("--device", default="cuda",
                    help="device of the trace contracts (default: cuda)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        print("\n".join(rule_ids()))
        return 0

    paths = args.paths or DEFAULT_PATHS
    only = args.rules.split(",") if args.rules else None
    findings = analyze_paths(paths, only=only)

    if args.write_baseline:
        Baseline.write(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    level = args.contracts
    if level is None:
        level = "static" if args.ci else "none"
    if level != "none":
        from repro_torch.analysis.repo_contracts import all_contracts

        findings.extend(check_contracts(
            all_contracts(level, device=args.device), level))

    gated = Baseline.load(args.baseline).filter(findings)
    baselined = len(findings) - len(gated)

    print(render(gated))
    if baselined:
        print(f"({baselined} baselined finding(s) not shown)")
    if args.ci and gated:
        print("analyze: FAIL — fix the findings above, suppress a reviewed "
              "exception inline with '# repro: ignore[rule]', or (last "
              "resort) --write-baseline", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
