#!/usr/bin/env python3
"""Where one dry-run cell's trace time goes, on the CPU.

    PYTHONPATH=src python3 tools/dryrun_profile.py --arch zamba2-7b \\
        --shape prefill_32k [--layers 2] [--multi-pod] [--every-step]
        [--tree DIR]

Runs ``launch.dryrun.cell_stats`` on one (arch, shape) cell at published
width on the fake 256-rank ``pod16x16`` group (512 ranks ``pod2x16x16``
with ``--multi-pod``), its ``n_layers`` cut to ``--layers`` (0 keeps the
config's), and prints the trace seconds beside the seconds spent inside
the state recurrence (the calls ``models.ssm`` makes: ``local_recurrence``
on a tree that has it, else ``chunked_decay_recurrence`` and
``decay_step``) and inside ``torch.autograd.grad`` (the train step's
backward; with remat it recomputes the forward, the recurrence too), and
the record's flops, collective bytes and argument bytes.
``--every-step`` counts every step of the loops the dry-run otherwise
trip-weights (``cell_stats(trip_weighting=False)``).  ``--tree``
imports ``repro_torch`` from another checkout (``kernel_tree.use_tree``),
so a parent and a change are timed by the same tool.  No card, no
kernel: fake tensors only.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import time

import kernel_tree as kt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--every-step", action="store_true")
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    if args.tree:
        kt.use_tree(args.tree)

    import torch

    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    import repro_torch.models.ssm as ssm

    seconds = {"recurrence": 0.0, "backward": 0.0}
    calls = {"recurrence": 0, "backward": 0}

    def timed(fn, key):
        @functools.wraps(fn)
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                seconds[key] += time.perf_counter() - t0
                calls[key] += 1
        return run

    names = (("local_recurrence",) if hasattr(ssm, "local_recurrence")
             else ("chunked_decay_recurrence", "decay_step"))
    for name in names:
        setattr(ssm, name, timed(getattr(ssm, name), "recurrence"))
    torch.autograd.grad = timed(torch.autograd.grad, "backward")

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    with dryrun.fake_group(512 if args.multi_pod else 256):
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type="cpu")
        t0 = time.perf_counter()
        kw = {"trip_weighting": False} if args.every_step else {}
        rec, failed = None, None
        try:
            rec = dryrun.cell_stats(cfg, SHAPES[args.shape], mesh, **kw)
        except Exception as e:     # reported with the seconds until then
            failed = f"{type(e).__name__}: {str(e)[:300]}"
        wall = time.perf_counter() - t0
    print(f"{args.arch} x {args.shape} x "
          f"{'pod2x16x16' if args.multi_pod else 'pod16x16'}, "
          f"{cfg.n_layers} layers: "
          + (f"failed after {wall:.1f} s ({failed})" if failed else
             f"trace {rec['trace_s']} s (wall {wall:.1f})")
          + f"; recurrence {seconds['recurrence']:.1f} s in "
          f"{calls['recurrence']} calls; autograd.grad "
          f"{seconds['backward']:.1f} s in {calls['backward']} calls")
    if failed:
        return 1
    print(f"flops/device {rec['flops_per_device']:.6e}, collective "
          f"bytes/device {rec['total_collective_bytes']:.6e}, arguments "
          f"{rec['memory_analysis']['argument_size_in_bytes']} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
