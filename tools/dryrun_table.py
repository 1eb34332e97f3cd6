#!/usr/bin/env python3
"""The dry-run's records as one markdown table, both meshes side by side.

    PYTHONPATH=src python3 tools/dryrun_table.py [--dir dryrun_results_torch]

Reads every record ``python -m repro_torch.launch.dryrun --all`` wrote
and prints, per (arch, shape) that is not skipped, for ``pod16x16`` and
``pod2x16x16``: flops, HBM bytes and collective wire bytes per device,
the trace seconds, and the term that bounds the cell in
``launch.roofline`` at the H100's data-sheet rates (``roofline.H100``)
with its seconds.  Then the counts: records, skipped (with their
reasons), counted, errors, and the largest ``trace_s``.  These are
counts from shapes on fake tensors, not measurements.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

MESHES = ("pod16x16", "pod2x16x16")


def main():
    from repro_torch.config import SHAPES
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import RESULTS_DIR

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR)
    args = ap.parse_args()
    recs = {}
    for f in glob.glob(os.path.join(args.dir, "*.json")):
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("variant", "baseline") == "baseline":
            recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec

    def cell(rec):
        if rec is None:
            return "missing"
        if "error" in rec:
            return "error"
        row = roofline.roofline_row(roofline._enrich(dict(rec)))
        term = row["dominant"]
        return (f"{rec['flops_per_device']:.3e} | "
                f"{rec['hbm_bytes_per_device']:.3e} | "
                f"{rec['total_collective_bytes']:.3e} | {rec['trace_s']} | "
                f"{term} {row[term + '_s']:.3g}")

    cols = ("flops/dev", "HBM B/dev", "coll B/dev", "trace s", "bound s")
    print("| arch | shape | " + " | ".join(
        f"{m} {c}" for m in MESHES for c in cols) + " |")
    print("| --- | --- |" + " ---: |" * (len(MESHES) * len(cols)))
    for arch in ARCH_IDS:
        for shape in SHAPES:
            got = [recs.get((arch, shape, m)) for m in MESHES]
            if all(r is not None and "skipped" in r for r in got):
                continue
            print(f"| {arch} | {shape} | "
                  + " | ".join(cell(r) for r in got) + " |")
    skipped = [r for r in recs.values() if "skipped" in r]
    errors = [r for r in recs.values() if "error" in r]
    counted = [r for r in recs.values()
               if "skipped" not in r and "error" not in r]
    worst = max(counted, key=lambda r: r["trace_s"], default=None)
    print(f"\n{len(recs)} records: {len(skipped)} skipped "
          f"({sorted({r['skipped'] for r in skipped})}), {len(counted)} "
          f"counted, {len(errors)} errors"
          + (f"; largest trace_s {worst['trace_s']} ({worst['arch']} x "
             f"{worst['shape']} x {worst['mesh']})" if worst else ""))


if __name__ == "__main__":
    sys.exit(main())
