"""Multi-pod dry-run (counterpart of ``repro.launch.dryrun``): run every
(architecture x input-shape x mesh) cell's step against the production
mesh with no memory behind it, and record its per-device memory, flops,
HBM bytes and collectives.

This entry point touches no device, like the reference's
(``ShapeDtypeStruct`` inputs on 512 fake host devices).  Its process
group is torch's fake backend (``FakeProcessGroup``: every collective
returns at once, moving nothing) at 256 or 512 ranks, this process
standing for rank 0; its mesh is ``device_type="cpu"``; and every tensor
is a ``FakeTensor`` (a shape and a dtype, no storage).  The step runs
eagerly on those, op by op, and ``op_stats.OpStats`` counts what rank 0
dispatches; the reference lowers and compiles instead.  A Shard->Shard
redistribution counts as the card's mesh sends it, one all-to-all of the
local shard (:func:`card_alltoall`), not as DTensor's fallback for a
``cpu`` mesh, an all-gather of n times the bytes.  Two loops whose
steps have the same shapes run in part and are counted for all of their
steps, as the reference's while bodies are weighted by their trip counts
(``op_stats``'s docstring): the recurrence's chunks (``op_stats.scan``)
and the train step's microbatches (``op_stats.trips``); ``cell_stats``'s
``trip_weighting=False`` runs every step.  The model path lays out by
hand what DTensor cannot plan on fake tensors or would repeat on every
rank (``sharding/perf.py``'s explicit actions), so that every cell of
both meshes counts, each within 10 minutes on a CPU.

``--all`` runs the ten archs x four shapes on both ``pod16x16`` (256 fake
ranks) and ``pod2x16x16`` (512; axes ``pod``, ``data``, ``model``): 80
records, 14 skipped with the reference's reason (long_500k on the seven
full-attention archs) and 66 counted.  One process runs the cells one
after another, in about 75 minutes (the slowest cell about 4
minutes); separate ``--arch``/``--shape`` invocations can run side by
side, as the sweep is resumable.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k [--multi-pod] [--variant strict_heads]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # resumable

Results land in dryrun_results_torch/<arch>__<shape>__<mesh>.json at the
root of the checkout; existing files are skipped.  A record has the
reference's keys but two: its ``lower_s`` and ``compile_s`` are one
``trace_s`` (nothing is compiled), and there is no ``cost_analysis_raw``
(an XLA object).  ``memory_analysis`` holds ``argument_size_in_bytes``
and ``output_size_in_bytes`` (rank 0's shard bytes of the placed inputs
and of the outputs), ``alias_size_in_bytes`` (outputs written into
inputs: the decode cache, which the port writes in place where the
reference donates it; the port's train step makes a new state, so its
alias is 0 where the reference donates the state) and
``temp_size_in_bytes`` (the peak of the storage the step's ops made and
held at once); no ``generated_code_size_in_bytes``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_stats import OpStats
from repro_torch.launch.steps import (build_step, default_microbatches,
                                      input_shardings)
from repro_torch.pytree import leaves, tree_map
from repro_torch.sharding import perf, rules

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results_torch")


def should_skip(cfg, shape) -> str:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention architecture: long_500k requires "
                "sub-quadratic attention (DESIGN.md skip table)")
    return ""


@contextlib.contextmanager
def fake_group(world_size: int):
    """A default process group of ``world_size`` ranks on torch's fake
    backend, this process rank 0, destroyed on exit.  Refuses to start
    under a group that is already initialised."""
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake process group; "
                           "one is already initialised")
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def card_alltoall():
    """Inside the block, a Shard->Shard redistribution of fake tensors on
    a ``cpu`` mesh dispatches ``_dtensor.shard_dim_alltoall``, the op
    DTensor sends on the card's NCCL mesh, which ``op_stats`` counts as
    one all-to-all of the local shard's bytes times (n-1)/n.

    Needed because ``torch.distributed.tensor._collective_utils
    .shard_dim_alltoall`` branches on ``mesh.device_type == "cpu"``
    ("Gloo does not support alltoall") to an ``all_gather_single`` plus a
    chunk: on the dry-run's ``cpu`` mesh the count would hold an
    all-gather of n times the all-to-all's wire bytes.  The function is
    replaced where it is looked up, in ``placement_types`` (which imports
    it by name for ``Shard._to_new_shard_dim``) and in
    ``_collective_utils``, and restored on exit, an exception included.
    Real tensors and other meshes keep DTensor's own path, so a gloo
    mesh redistributes as before, inside the block too."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import _collective_utils, placement_types

    modules = (_collective_utils, placement_types)
    saved = [m.shard_dim_alltoall for m in modules]
    dtensor_own = saved[0]

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu" or not isinstance(input, FakeTensor):
            return dtensor_own(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    try:
        for m in modules:
            m.shard_dim_alltoall = alltoall
        yield
    finally:
        for m, fn in zip(modules, saved):
            m.shard_dim_alltoall = fn


def _local_bytes(tree) -> int:
    return sum(x.to_local().numel() * x.element_size() for x in leaves(tree))


def _storages(tree) -> set:
    return {id(x.to_local().untyped_storage()) for x in leaves(tree)}


def cell_stats(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               microbatches=None, trip_weighting: bool = True,
               watch=None) -> dict:
    """One cell on ``mesh`` (a ``DeviceMesh`` over a fake group): the
    step from ``launch.steps.build_step``, its inputs made as fake tensors
    and placed by the rules before the count starts (the reference's
    arguments arrive placed), then the step run once inside
    ``OpStats``'s window, its Shard->Shard redistributions sent as the
    card's all-to-all (:func:`card_alltoall`).  ``watch`` sees every op
    of the window that reaches DTensor's dispatch (``OpStats``).  Returns
    the record's measured fields."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    kw = {"microbatches": microbatches} if shape.kind == "train" else {}
    fn, structs = build_step(cfg, mesh, shape, **kw)
    specs = input_shardings(cfg, mesh, shape.kind, structs)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_mode:
        args = tuple(
            rules.distribute_tree(tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      device=mesh.device_type), s), sp, mesh)
            for s, sp in zip(structs, specs))
    t0 = time.perf_counter()
    with card_alltoall(), \
            OpStats(fake_mode, trip_weighting=trip_weighting,
                    watch=watch) as stats:
        out = fn(*args)
    trace_s = time.perf_counter() - t0

    summary = stats.summary()
    ins = _storages(args)
    alias = sum(x.to_local().numel() * x.element_size()
                for x in leaves(out)
                if id(x.to_local().untyped_storage()) in ins)
    mb = (default_microbatches(cfg, shape)
          if (shape.kind == "train" and microbatches is None)
          else microbatches)
    return {
        "n_devices": mesh.size(),
        "microbatches": mb if shape.kind == "train" else None,
        "trace_s": round(trace_s, 1),
        "memory_analysis": {
            "argument_size_in_bytes": _local_bytes(args),
            "output_size_in_bytes": _local_bytes(out),
            "temp_size_in_bytes": stats.peak_bytes,
            "alias_size_in_bytes": alias,
        },
        "flops_per_device": summary.flops,
        "hbm_bytes_per_device": summary.hbm_bytes,
        "collective_bytes_per_device": summary.coll_bytes,
        "collective_counts": summary.coll_counts,
        "total_collective_bytes": summary.total_coll_bytes,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             microbatches=None, variant: str = "baseline") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    skip = should_skip(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    meta = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variant": variant,
        "kind": shape.kind,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
    }
    if skip:
        return {**meta, "skipped": skip}
    with perf.variant(variant), fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        return {**meta, **cell_stats(cfg, shape, mesh,
                                     microbatches=microbatches)}


def cell_path(arch, shape_name, multi_pod, variant="baseline"):
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    return os.path.join(
        RESULTS_DIR, f"{arch}__{shape_name}__{mesh_name}{suffix}.json")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--variant", default="baseline",
                    choices=list(perf.VARIANTS))
    args = ap.parse_args()

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in (False, True):
                    cells.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are required unless --all is set")
        cells.append((args.arch, args.shape, args.multi_pod))

    for arch, shape, mp in cells:
        path = cell_path(arch, shape, mp, args.variant)
        if os.path.exists(path) and not args.force:
            print(f"[skip existing] {path}")
            continue
        print(f"=== {arch} x {shape} x "
              f"{'pod2x16x16' if mp else 'pod16x16'} ===", flush=True)
        try:
            res = run_cell(arch, shape, multi_pod=mp,
                           microbatches=args.microbatches,
                           variant=args.variant)
        except Exception as e:   # recorded; the sweep goes on
            res = {
                "arch": arch, "shape": shape,
                "mesh": "pod2x16x16" if mp else "pod16x16",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
            print(res["error"], flush=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        if "skipped" in res:
            print(f"skipped: {res['skipped']}")
        elif "error" not in res:
            print(f"ok: flops/dev={res['flops_per_device']:.3e} "
                  f"hbm/dev={res['hbm_bytes_per_device']:.3e} "
                  f"coll/dev={res['total_collective_bytes']:.3e} "
                  f"trace={res['trace_s']}s", flush=True)


if __name__ == "__main__":
    main()
