#!/usr/bin/env python3
"""Every DTensor redistribution of the smoke cells, in order, by call site:
the tool that finds where two torch versions plan the sharded path apart.

    PYTHONPATH=src python3 tools/dryrun_redist.py --out here.json \\
        [--archs zamba2-7b,arctic-480b] [--kinds train,prefill,decode]
    python3 tools/dryrun_redist.py --diff here.json card.json [--cell K]

The first form runs the smoke cells of ``tests/test_torch_dryrun.py``
(each arch's smoke config, 8 rows x 32 positions, train in 2
microbatches) on its (2, 4) fake group, counted by
``launch.dryrun.cell_stats``, and records for each cell its flops and
collective bytes per device and every redistribution DTensor makes, in
order: whether DTensor made it inside an op (``implicit``) or the model
asked for it (``explicit``), the source and target placements, the
global shape, and its call site (``tools/dryrun_profile.call_site``: the
two innermost ``repro_torch`` frames; in the backward, the forward line
that made the node).  Run it on two machines (here, and on the card's
with ``CUDA_VISIBLE_DEVICES=``), then ``--diff`` prints each cell's
counts side by side and, for a cell whose flops or collective bytes
differ, the redistributions one torch makes and the other does not, by
site.  No card, no kernel: fake tensors only.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
import time
import warnings

import dryrun_profile as DP


def record(out: str, archs, kinds) -> None:
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import _dispatch, _redistribute

    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun

    rows = []

    def wrap(mod, tag):
        own = mod.redistribute_local_tensor

        def red(local, cur, tgt, *a, **kw):
            rows.append([tag, DP.call_site(), str(tuple(cur.placements)),
                         str(tuple(tgt.placements)), list(cur.shape)])
            return own(local, cur, tgt, *a, **kw)

        mod.redistribute_local_tensor = red

    # DTensor's own redistributions inside an op, and the models' own
    wrap(_dispatch, "implicit")
    wrap(_redistribute, "explicit")
    res = {"torch": torch.__version__, "cells": {}}
    with dryrun.fake_group(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        for arch in archs:
            for kind in kinds:
                rows.clear()
                t0 = time.perf_counter()
                try:
                    with warnings.catch_warnings():
                        warnings.filterwarnings("ignore")
                        with torch.autograd.detect_anomaly(check_nan=False):
                            r = dryrun.cell_stats(
                                get_smoke_config(arch),
                                ShapeConfig(kind, 32, 8, kind), mesh,
                                microbatches=2 if kind == "train" else None)
                    rec = {"flops": r["flops_per_device"],
                           "coll": r["total_collective_bytes"],
                           "counts": r["collective_counts"]}
                except Exception as e:   # recorded; the next cell runs
                    rec = {"error": f"{type(e).__name__}: {e}"[:500]}
                rec["redist"] = list(rows)
                res["cells"][f"{arch}|{kind}"] = rec
                print(f"{arch} x {kind}: {rec.get('error') or rec['coll']}"
                      f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    with open(out, "w") as fh:
        json.dump(res, fh)


def _by_site(rec) -> collections.Counter:
    return collections.Counter(
        (re.sub(r":\d+", "", site), src, dst, str(shape))
        for _, site, src, dst, shape in rec["redist"])


def diff(a_path: str, b_path: str, only=None) -> None:
    with open(a_path) as fa, open(b_path) as fb:
        a, b = json.load(fa), json.load(fb)
    print(f"A: torch {a['torch']}, B: torch {b['torch']}")
    for key in sorted(a["cells"]):
        if only and key != only:
            continue
        x, y = a["cells"][key], b["cells"].get(key, {"error": "absent"})
        if "error" in x or "error" in y:
            print(f"{key}: A {x.get('error', 'counted')}, "
                  f"B {y.get('error', 'counted')}")
            continue
        ratio = y["coll"] / x["coll"] if x["coll"] else 1.0
        print(f"{key}: flops A {x['flops']:.0f} B {y['flops']:.0f}; "
              f"collective bytes A {x['coll']:.0f} B {y['coll']:.0f} "
              f"({ratio:.4f}x)")
        if x["flops"] == y["flops"] and x["coll"] == y["coll"]:
            continue
        ca, cb = _by_site(x), _by_site(y)
        for k in sorted(set(ca) | set(cb)):
            if ca[k] != cb[k]:
                site, src, dst, shape = k
                print(f"  A {ca[k]} B {cb[k]}: {src} -> {dst} {shape} "
                      f"@ {site}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--archs", default="")
    ap.add_argument("--kinds", default="train,prefill,decode")
    ap.add_argument("--diff", nargs=2)
    ap.add_argument("--cell", default=None)
    args = ap.parse_args()
    if args.diff:
        diff(*args.diff, only=args.cell)
        return 0
    if not args.out:
        ap.error("--out or --diff is required")
    from repro_torch.configs import ARCH_IDS

    archs = args.archs.split(",") if args.archs else list(ARCH_IDS)
    record(args.out, archs, args.kinds.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
