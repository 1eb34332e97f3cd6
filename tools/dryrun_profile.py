#!/usr/bin/env python3
"""Where one dry-run cell's trace time and collective bytes go, on the CPU.

    PYTHONPATH=src python3 tools/dryrun_profile.py --arch zamba2-7b \\
        --shape prefill_32k [--layers 2] [--multi-pod] [--every-step]
        [--sites] [--tree DIR]
    PYTHONPATH=src python3 tools/dryrun_profile.py --arch qwen3-14b \\
        --shape decode --mesh 2x4 --sites

Runs ``launch.dryrun.cell_stats`` on one (arch, shape) cell at published
width on the fake 256-rank ``pod16x16`` group (512 ranks ``pod2x16x16``
with ``--multi-pod``), its ``n_layers`` cut to
``--layers`` (default 2; 0 keeps the config's), and prints the trace
seconds beside the seconds spent inside the state recurrence (the calls
``models.ssm`` makes: ``local_recurrence`` on a tree that has it, else
``chunked_decay_recurrence`` and ``decay_step``) and inside
``torch.autograd.grad`` (the train step's backward; with remat it
recomputes the forward, the recurrence too), and the record's flops,
collective bytes and argument bytes.  ``--mesh DxM`` (or ``PxDxM``)
runs a smoke cell instead, as ``tests/test_torch_dryrun.py`` does: the
arch's smoke config at its own depth, ``--shape`` a kind (train, prefill
or decode) of 8 rows x 32 positions, train in 2 microbatches, on a fake
group of that mesh's size with axes ``data``, ``model`` (``pod`` first
on three dims).  ``--every-step`` counts every step of the loops the
dry-run otherwise trip-weights (``cell_stats(trip_weighting=False)``).
``--sites`` splits the collective bytes of each kind by the two
innermost ``repro_torch`` frames that dispatched them (a helper and its
caller); a collective of the backward is put to the forward line that
made its autograd node (anomaly mode records it, NaN checks off), under
``backward of``.  ``--tree`` imports ``repro_torch`` from another
checkout (``kernel_tree.use_tree``), so a parent and a change are read
by the same tool.  No card, no kernel: fake tensors only.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import math
import re
import sys
import time
import traceback
import warnings

import kernel_tree as kt

#: frames of the counting machinery, never a site
NOT_SITES = ("launch/op_stats.py", "launch/dryrun.py")
#: a frame of a formatted stack (anomaly mode's record of a node)
FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')
#: sites below this share of the cell's collective bytes are summed as one
MIN_SHARE = 0.01


def _site(frames) -> str:
    """The two innermost ``repro_torch`` frames of ``frames`` (outermost
    first; each ``(file, line, function)``), innermost first."""
    ours = [(f.split("repro_torch/", 1)[1], line, fn)
            for f, line, fn in frames
            if "/repro_torch/" in f and not f.endswith(NOT_SITES)]
    return " < ".join(f"{f}:{line} {fn}" for f, line, fn in ours[::-1][:2]) \
        or "outside repro_torch"


def call_site() -> str:
    """The site of the collective being counted: in the backward, the
    forward line that made the running autograd node, else the stack."""
    import torch

    node = torch._C._current_autograd_node()
    made = node is not None and node.metadata.get("traceback_")
    if made:
        frames = [FRAME.search(ln).groups() for ln in "".join(made)
                  .splitlines() if FRAME.search(ln)]
        return "backward of " + _site(frames)
    here = [(f.filename, f.lineno, f.name)
            for f in traceback.extract_stack()]
    return ("backward: " if node is not None else "") + _site(here)


@contextlib.contextmanager
def counting_sites(sites):
    """Add each collective's wire bytes that ``OpStats`` counts to
    ``sites[(kind, call_site())]`` inside the block."""
    import torch

    from repro_torch.launch import op_stats

    count = op_stats.OpStats._count

    def by_site(self, *a):
        before = dict(self.coll_bytes)
        count(self, *a)
        for kind, b in self.coll_bytes.items():
            if b != before[kind]:
                sites[(kind, call_site())] += b - before[kind]

    op_stats.OpStats._count = by_site
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Anomaly Detection")
            with torch.autograd.detect_anomaly(check_nan=False):
                yield
    finally:
        op_stats.OpStats._count = count


def print_sites(sites, total: float) -> None:
    by_kind = collections.defaultdict(list)
    for (kind, site), b in sites.items():
        by_kind[kind].append((b, site))
    for kind, rows in sorted(by_kind.items(),
                             key=lambda kv: -sum(b for b, _ in kv[1])):
        rows.sort(reverse=True)
        kind_b = sum(b for b, _ in rows)
        print(f"{kind}: {kind_b:.6e} B ({kind_b / total:.1%} of the cell)")
        rest = 0.0
        for b, site in rows:
            if b < MIN_SHARE * total:
                rest += b
                continue
            print(f"  {b:.6e} B {b / total:6.1%}  {site}")
        if rest:
            print(f"  {rest:.6e} B {rest / total:6.1%}  (sites under "
                  f"{MIN_SHARE:.0%} each)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="a smoke cell's mesh, DxM or PxDxM")
    ap.add_argument("--every-step", action="store_true")
    ap.add_argument("--sites", action="store_true")
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    if args.tree:
        kt.use_tree(args.tree)

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import SHAPES, ShapeConfig
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    import repro_torch.models.ssm as ssm

    mesh_name = args.mesh or ("pod2x16x16" if args.multi_pod else "pod16x16")
    smoke = args.mesh is not None
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

    kw = {"trip_weighting": False} if args.every_step else {}
    if smoke:
        dims = tuple(int(d) for d in mesh_name.split("x"))
        axes = ("pod", "data", "model")[-len(dims):]
        cfg = get_smoke_config(args.arch)
        shape = ShapeConfig(args.shape, 32, 8, args.shape)
        if shape.kind == "train":
            kw["microbatches"] = 2
    else:
        cfg = get_config(args.arch)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        shape = SHAPES[args.shape]
    sites = collections.defaultdict(float)
    n = math.prod(dims) if smoke else (512 if args.multi_pod else 256)
    with dryrun.fake_group(n):
        mesh = (init_device_mesh("cpu", dims, mesh_dim_names=axes) if smoke
                else make_production_mesh(multi_pod=args.multi_pod,
                                          device_type="cpu"))
        t0 = time.perf_counter()
        rec, failed = None, None
        try:
            with counting_sites(sites) if args.sites \
                    else contextlib.nullcontext():
                rec = dryrun.cell_stats(cfg, shape, mesh, **kw)
        except Exception as e:     # reported with the seconds until then
            failed = f"{type(e).__name__}: {str(e)[:300]}"
        wall = time.perf_counter() - t0
    print(f"{args.arch} x {args.shape} x {mesh_name}, "
          f"{cfg.n_layers} layers: "
          + (f"failed after {wall:.1f} s ({failed})" if failed else
             f"trace {rec['trace_s']} s (wall {wall:.1f})")
          + f"; recurrence {seconds['recurrence']:.1f} s in "
          f"{calls['recurrence']} calls; autograd.grad "
          f"{seconds['backward']:.1f} s in {calls['backward']} calls")
    if failed:
        return 1
    counts = {k: int(v) for k, v in rec["collective_counts"].items() if v}
    print(f"flops/device {rec['flops_per_device']:.6e}, collective "
          f"bytes/device {rec['total_collective_bytes']:.6e} {counts}, "
          f"arguments {rec['memory_analysis']['argument_size_in_bytes']} B")
    if args.sites:
        print_sites(sites, rec["total_collective_bytes"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
