"""The port's dry-run tooling (``repro_torch.launch.op_stats``, ``dryrun``,
``roofline``) against the reference's (``repro.launch.hlo_stats``,
``dryrun``, ``roofline``) on the CPU.

The reference's compiled cells run in JAX subprocesses on 8 host devices
(``--xla_force_host_platform_device_count=8``, as
``tests/test_distribution.py`` runs its meshes): importing
``repro.launch.dryrun`` rewrites ``XLA_FLAGS`` to 512 devices, which
must not reach this process's later JAX tests.  ``hlo_stats`` and
``roofline`` are plain Python and are imported here.  The port's smoke
cells run in subprocesses of their own, each on a fake process group
(``dryrun.fake_group``) over fake tensors, all started with the module so
that they run beside its other tests.

* ``should_skip`` and the record's config fields equal the reference's
  for every (arch, shape).
* ``op_stats`` against ``hlo_stats.analyze`` with ``==``: dots (batched,
  two contracting dims, with a bias) on hand-written HLO and the same
  products on fake tensors; each of the five collective kinds at 2, 4
  and 8 ranks in both ``replica_groups`` forms against the same
  collective on a fake group.
* The 16 x 16 product counts one device's flops and two all-gathers.
* A Shard->Shard redistribution inside ``dryrun.card_alltoall`` counts
  the all-to-all the card's mesh sends, equal to ``hlo_stats``'s count of
  the same all-to-all; outside it, and on real tensors of a 2-rank gloo
  mesh inside it too, DTensor keeps its own path (the CPU mesh's
  all-gather and chunk), and the hook is undone after an exception.
* Every arch's smoke config, ``ShapeConfig(kind, 32, 8, kind)``, train
  at 2 microbatches, against the reference's compiled HLO: on a 1 x 1
  mesh prefill and decode flops equal, train three quarters of the
  reference's (its forward runs twice, ``test_smoke_1x1``), arguments
  equal, no collective, and where an arch departs the gap equal to a
  formula from the shapes; on the (2, 4) mesh every cell counts, the
  arguments' bytes equal, train flops exactly the 1 x 1 count over 8,
  prefill and decode flops within 10%, and collectives present exactly
  where the reference has them, the MoE archs' train and prefill with
  all-to-alls and within 1.25x the reference's collective bytes; on a
  ("pod", "data", "model") 2 x 2 x 2 mesh qwen1.5-4b's and arctic-480b's
  arguments equal and collectives where the reference has them; on every
  mesh a cell counts all-to-alls exactly when DTensor redistributes
  Shard->Shard in it.
* zamba2 and rwkv smoke: the flops gap to the reference, from the shapes.
* Work a mesh dim cannot divide is split, not repeated: rwkv's smoke
  prefill and decode on a (1, 8) mesh, whose ``model`` dim divides
  neither its 4 heads nor shards its rows, count the 1 x 1 flops split
  over 8 with the recurrence's split over the heads padded to 8 (a
  formula from the shapes), no more than the reference's on that mesh;
  arctic at published width (1 layer, a 512-token vocabulary, prefill_32k's
  2^20 tokens) counts on the two pods exactly half of one pod's flops.
* The trip-weighted count (``op_stats.trips``, ``op_stats.scan``) equal
  to every step counted: rwkv's and zamba2's smoke train step on both
  meshes, and the chunked recurrence over six chunks.
* The roofline's functions equal the reference's on the same records.
* ``run_cell`` leaves no process group and refuses under one.
* qwen1.5-4b x decode_32k at full width on the 16 x 16 pod: the
  arguments' bytes equal the rules' local shards of the real leaves.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import _collective_utils, placement_types

from repro.launch import hlo_stats as J_hlo
from repro.launch import roofline as J_roof
from repro_torch.config import SHAPES, ShapeConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import MeshShape, make_debug_mesh
from repro_torch.launch.op_stats import COLLECTIVES, OpStats
from repro_torch.models.registry import get_model
from repro_torch.pytree import flatten_with_path
from repro_torch.launch import steps as ST
from repro_torch.sharding import perf, rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECURRENT = ("zamba2-7b", "rwkv6-3b")
#: every arch but the recurrent two, whose prefill and decode gaps
#: ``test_recurrence_and_branch_gaps`` holds
SMOKE = tuple(a for a in ARCH_IDS if a not in RECURRENT)
KINDS = ("train", "prefill", "decode")
MESHES = {"1x1": (1, 1), "2x4": (2, 4)}
AXES = ("data", "model")
#: the axes of ``make_production_mesh(multi_pod=True)`` on 8 devices
POD = {"2x2x2": (2, 2, 2)}
POD_AXES = ("pod", "data", "model")
POD_ARCHS = ("qwen1.5-4b", "arctic-480b")
FLOPS_REL = 0.10            # the (2, 4) mesh's flops against the reference
#: the MoE archs, whose expert combine redistributes Shard->Shard
MOE = ("arctic-480b", "qwen3-moe-235b-a22b")
#: their (2, 4) train and prefill collective bytes against the reference's
A2A_REL = 1.25
#: the (2, 4) cells' collective bytes per device once their layouts were
#: spelled out (the embedding lookup of zamba2 and whisper and a decode
#: step's lookup, the MoE dispatch, experts and combine, the layer norm,
#: Mamba2's conv, attention over a position-split cache): no cell may
#: count more
COLL_CEIL = {
    "gemma-2b|train": 1162776,
    "gemma-2b|prefill": 314880,
    "gemma-2b|decode": 45728,
    "gemma3-1b|train": 2019352,
    "gemma3-1b|prefill": 621056,
    "gemma3-1b|decode": 62144,
    "qwen1.5-4b|train": 1089816,
    "qwen1.5-4b|prefill": 290304,
    "qwen1.5-4b|decode": 41760,
    "qwen3-14b|train": 1212824,
    "qwen3-14b|prefill": 335360,
    "qwen3-14b|decode": 44192,
    "arctic-480b|train": 5708072,
    "arctic-480b|prefill": 1902728,
    "arctic-480b|decode": 93800,
    "qwen3-moe-235b-a22b|train": 7860208,
    "qwen3-moe-235b-a22b|prefill": 2649548,
    "qwen3-moe-235b-a22b|decode": 111116,
    "zamba2-7b|train": 3355568,
    "zamba2-7b|prefill": 1548160,
    "zamba2-7b|decode": 100360,
    "internvl2-26b|train": 1216024,
    "internvl2-26b|prefill": 335360,
    "internvl2-26b|decode": 44192,
    "rwkv6-3b|train": 3106456,
    "rwkv6-3b|prefill": 900632,
    "rwkv6-3b|decode": 173160,
    "whisper-large-v3|train": 1760280,
    "whisper-large-v3|prefill": 509440,
    "whisper-large-v3|decode": 44320,
}
#: a ``model`` dim of 8 over rwkv's 4 smoke heads: it divides neither
#: the heads nor shards the rows, and divides every other product's dims
UNEVEN = {"1x8": (1, 8)}
UNEVEN_KINDS = ("prefill", "decode")
#: the index writes whose operands must all be replicated on a mesh (the
#: card's torch plans a sharded one's rows past a shard, or not at all)
INDEX_PUTS = ("index_put", "index_put_", "_index_put_impl_")
#: the same on the three-axis mesh
POD_CEIL = {
    "qwen1.5-4b|train": 1295904, "qwen1.5-4b|prefill": 211456,
    "qwen1.5-4b|decode": 98096, "arctic-480b|train": 9939520,
    "arctic-480b|prefill": 4567312, "arctic-480b|decode": 224064,
}
#: arctic-480b at published width, 1 layer and a 512-token vocabulary,
#: prefilling 2048 x 512 tokens: prefill_32k's 2^20 tokens, so its
#: experts' capacity, at a fifth of its trace time
POD_CELL = ({"n_layers": 1, "vocab": 512}, 512, 2048)

REF_BODY = r'''
import os
# LLVM's optimisation changes the machine code only, not the compiled HLO
# the counts read (the same flops, collectives and arguments), and halves
# the compile time
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
import collections, json, re
import jax
import numpy as np
jax.devices()          # 8 devices before repro.launch.dryrun sets 512
from repro.config import SHAPES, ShapeConfig
from repro.configs import ARCH_IDS, get_config, get_smoke_config
from repro.launch import dryrun, hlo_stats as H
from repro.launch.steps import build_step


def split(txt):
    """Trip-weighted dot flops by origin: the forward the train step's
    value computes ("primal"), its linearized copy ("jvp") and the
    backward ("transpose"), read from each dot's op_name."""
    comps = H.parse_hlo(txt)
    dots, cur, defs = collections.defaultdict(list), None, {}
    for raw in txt.splitlines():
        m = H._COMP_HDR.match(raw)
        if m:
            cur, defs = m.group(2), {}
            continue
        om = H._OP_RE.match(raw) if cur else None
        if not om:
            continue
        name, rhs = om.groups()
        shape_tok, op, rest = H._split_result_and_op(rhs)
        sm = H._SHAPE_TOKEN.search(shape_tok)
        if sm:
            defs["__shape__" + name] = tuple(
                int(d) for d in sm.group(2).split(",") if d)
        if op == "dot":
            f = H._dot_flops(shape_tok, rest, defs,
                             re.findall(r"%([\w.\-]+)", rest))
            on = re.search(r'op_name="([^"]*)"', rest)
            on = on.group(1) if on else ""
            kind = ("transpose" if "transpose(" in on else
                    "jvp" if "jvp(" in on else "primal")
            dots[cur].append((f, kind))
    out = collections.Counter()

    def visit(name, mult):
        st = comps[name]
        for f, kind in dots.get(name, []):
            out[kind] += f * mult
        for child, m, _ in st.children:
            if child in comps:
                if m < 0:
                    m = max(float(comps[child].max_constant),
                            float(st.max_constant), 1.0)
                visit(child, mult * m)

    entry = next(k for k, v in comps.items()
                 if k != "__entry__" and v is comps["__entry__"])
    visit(entry, 1.0)
    return dict(out)


def cell(arch, kind, dims, axes):
    devs = np.array(jax.devices()[:int(np.prod(dims))]).reshape(dims)
    mesh = jax.sharding.Mesh(devs, tuple(axes))
    kw = {"microbatches": 2} if kind == "train" else {}
    with mesh:
        fn, structs = build_step(get_smoke_config(arch), mesh,
                                 ShapeConfig(kind, 32, 8, kind), **kw)
        c = fn.lower(*structs).compile()
    txt = c.as_text()
    s = H.analyze(txt)
    return {"flops": s.flops, "coll": s.total_coll_bytes,
            "counts": s.coll_counts,
            "arg": int(c.memory_analysis().argument_size_in_bytes),
            "split": split(txt) if kind == "train" else None}


out = {"skip": {}, "meta": {}, "cells": {},
       "shapes": {s: [sh.kind, sh.seq_len, sh.global_batch]
                  for s, sh in SHAPES.items()}}
for a in ARCH_IDS:
    cfg = get_config(a)
    out["meta"][a] = {"params": cfg.param_count(),
                      "active_params": cfg.active_param_count()}
    for s, sh in SHAPES.items():
        out["skip"][a + "|" + s] = dryrun.should_skip(cfg, sh)
for a, kind, name, dims, axes in JOBS:
    out["cells"][f"{a}|{kind}|{name}"] = cell(a, kind, dims, axes)
print("REF " + json.dumps(out))
'''

PORT_BODY = r'''
import json, math
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import Shard
from torch.utils._pytree import tree_leaves
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun

# the Shard->Shard redistributions each cell runs (a method of the class,
# which ``card_alltoall`` leaves as it is)
moves = [0]
to_new_shard_dim = Shard._to_new_shard_dim


def counting(self, *a, **kw):
    moves[0] += 1
    return to_new_shard_dim(self, *a, **kw)


Shard._to_new_shard_dim = counting
# every index write that reaches DTensor's dispatch, with its DTensor
# operands' placements
writes = []


def watch(func, args, kwargs):
    if func.overloadpacket.__name__ in INDEX_PUTS:
        writes.append([str(func), [
            str(p) for t in tree_leaves((args, kwargs))
            if isinstance(t, DTensor) for p in t.placements]])


out, redistributed, index_puts = {}, {}, {}
for name, dims, axes, cells in GROUPS:
    with dryrun.fake_group(math.prod(dims)):
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=axes)
        for key, arch, kind, seq, mb, weighting in cells:
            moves[0] = 0
            writes.clear()
            out[key] = dryrun.cell_stats(
                get_smoke_config(arch), ShapeConfig(kind, seq, 8, kind),
                mesh, microbatches=mb if kind == "train" else None,
                trip_weighting=weighting, watch=watch)
            redistributed[key] = moves[0]
            index_puts[key] = list(writes)
print("PORT " + json.dumps({"cells": out, "shard_to_shard": redistributed,
                            "index_puts": index_puts}))
'''


POD_CELL_BODY = r'''
import dataclasses, json
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

over, seq, batch = POD_CELL
cfg = dataclasses.replace(get_config("arctic-480b"), **over)
out = {}
for multi_pod, name, n in ((False, "pod16x16", 256),
                           (True, "pod2x16x16", 512)):
    with dryrun.fake_group(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        out[f"arctic-480b|prefill|{name}|experts"] = dryrun.cell_stats(
            cfg, ShapeConfig("prefill", seq, batch, "prefill"), mesh)
print("PORT " + json.dumps({"cells": out, "shard_to_shard": {},
                            "index_puts": {}}))
'''


GLOO_BODY = r'''
import datetime, json
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.launch import dryrun
from repro_torch.launch.op_stats import OpStats

dist.init_process_group("gloo", init_method="file://" + STORE, rank=RANK,
                        world_size=2, timeout=datetime.timedelta(seconds=60))
mesh = init_device_mesh("cpu", (2,))
full = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
x = distribute_tensor(full, mesh, [Shard(0)])
out = {}


def run(label):
    with OpStats() as stats:
        y = x.redistribute(mesh, [Shard(1)]).to_local()
    out[label] = {"equal": torch.equal(y, full[:, 3 * RANK:3 * RANK + 3]),
                  "counts": stats.coll_counts}


with dryrun.card_alltoall():
    run("inside the window")
try:
    with dryrun.card_alltoall():
        raise RuntimeError("boom")
except RuntimeError:
    pass
run("after an exception in it")
dist.destroy_process_group()
print("GLOO " + json.dumps(out))
'''


def _ref_jobs():
    """The reference's cells in three subprocesses of about equal work."""
    one = [(a, k, "1x1", (1, 1), AXES) for a in ARCH_IDS for k in KINDS]
    one += [("rwkv6-3b", k, n, dims, AXES) for k in UNEVEN_KINDS
            for n, dims in UNEVEN.items()]
    two = [(a, k, "2x4", (2, 4), AXES) for a in ARCH_IDS for k in KINDS]
    pod = [(a, k, n, dims, POD_AXES) for a in POD_ARCHS for k in KINDS
           for n, dims in POD.items()]
    return [one, two[:15] + pod, two[15:]]


def _port_groups():
    """The port's cells, ``(mesh name, dims, axes, [(key, arch, kind,
    seq, microbatches, trip weighting)])`` a subprocess, in six
    subprocesses of about equal work: every arch on both meshes, the
    three-axis mesh, and each recurrence's train step counted step by
    step, beside its trip-weighted smoke cell."""
    def smoke(name, archs):
        return [(f"{a}|{k}|{name}", a, k, 32, 2, True)
                for a in archs for k in KINDS]

    def every_step(name):
        return [(f"{a}|train|{name}|every step", a, "train", 32, 2, False)
                for a in RECURRENT]

    half = len(ARCH_IDS) // 2
    return [
        [("1x1", (1, 1), AXES, smoke("1x1", ARCH_IDS[:half]))],
        [("1x1", (1, 1), AXES, smoke("1x1", ARCH_IDS[half:]))],
        [("2x4", (2, 4), AXES, smoke("2x4", ARCH_IDS[:half + 1]))],
        [("2x4", (2, 4), AXES, smoke("2x4", ARCH_IDS[half + 1:]))],
        [("2x2x2", POD["2x2x2"], POD_AXES, smoke("2x2x2", POD_ARCHS))],
        [("1x1", (1, 1), AXES, every_step("1x1")),
         ("2x4", (2, 4), AXES, every_step("2x4"))]
        + [(n, dims, AXES, [(f"rwkv6-3b|{k}|{n}", "rwkv6-3b", k, 32, 2,
                             True) for k in UNEVEN_KINDS])
           for n, dims in UNEVEN.items()],
    ]


def _start(code: str):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _collect(procs, tag: str) -> list:
    out = []
    for proc in procs:
        stdout, err = proc.communicate(timeout=600)
        lines = [ln for ln in stdout.splitlines() if ln.startswith(tag)]
        assert proc.returncode == 0 and lines, err[-4000:]
        out.append(json.loads(lines[-1][len(tag):]))
    return out


@pytest.fixture(scope="module", autouse=True)
def procs():
    """Both sides' subprocesses, started with the module so that they run
    beside its tests that need neither."""
    ref = [_start(f"KINDS = {KINDS!r}\nJOBS = {jobs!r}\n" + REF_BODY)
           for jobs in _ref_jobs()]
    port = [_start(f"GROUPS = {groups!r}\nINDEX_PUTS = {INDEX_PUTS!r}\n"
                   + PORT_BODY) for groups in _port_groups()]
    port.append(_start(f"POD_CELL = {POD_CELL!r}\n" + POD_CELL_BODY))
    store = os.path.join(tempfile.mkdtemp(), "store")
    gloo = [_start(f"STORE = {store!r}\nRANK = {rank}\n" + GLOO_BODY)
            for rank in range(2)]
    yield {"ref": ref, "port": port, "gloo": gloo}
    for proc in ref + port + gloo:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref(procs):
    parts = _collect(procs["ref"], "REF ")
    out = parts[0]
    for part in parts[1:]:
        out["cells"].update(part["cells"])
    return out


def _cell_record(arch, kind, cfg, mesh_name, stats) -> dict:
    """A port record of a smoke cell, with the meta keys of
    ``run_cell``'s."""
    return {"arch": arch, "shape": f"smoke_{kind}", "mesh": mesh_name,
            "variant": "baseline", "kind": kind,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(), "seq_len": 32,
            "global_batch": 8, **stats}


@pytest.fixture(scope="module")
def counted_parts(procs):
    """Every record the port's subprocesses counted, by key, the
    Shard->Shard redistributions each smoke cell ran and the index
    writes that reached DTensor's dispatch in it."""
    out, moves, writes = {}, {}, {}
    for part in _collect(procs["port"], "PORT "):
        out.update(part["cells"])
        moves.update(part["shard_to_shard"])
        writes.update(part["index_puts"])
    return out, moves, writes


@pytest.fixture(scope="module")
def counted(counted_parts):
    """Every record the port's subprocesses counted, by key."""
    return counted_parts[0]


@pytest.fixture(scope="module")
def port(counted):
    """The port's smoke cells: {"arch|kind|mesh": record}."""
    out = {}
    for key, stats in counted.items():
        parts = key.split("|")
        if len(parts) == 3:
            arch, kind, name = parts
            out[key] = _cell_record(arch, kind, get_smoke_config(arch),
                                    name, stats)
    return out


# ---------------------------------------------------------------------------
# op_stats against hlo_stats on the same dots and collectives
# ---------------------------------------------------------------------------


def _hlo(params: dict, root: str) -> str:
    """A one-op HLO module: ``params`` {name: "f32[...]"} and the root
    op's line."""
    sig = ", ".join(f"{n}: {t}" for n, t in params.items())
    lines = [f"  %{n} = {t} parameter({i})"
             for i, (n, t) in enumerate(params.items())]
    return ("HloModule m\n\n%add (x: f32[], y: f32[]) -> f32[] {\n"
            "  %x = f32[] parameter(0)\n  %y = f32[] parameter(1)\n"
            "  ROOT %s = f32[] add(%x, %y)\n}\n\n"
            f"ENTRY %main ({sig}) -> f32[] {{\n" + "\n".join(lines)
            + f"\n  ROOT {root}\n}}\n")


def _fake_count(fn, *shapes):
    fake_mode = FakeTensorMode()
    with fake_mode:
        xs = [torch.empty(s) for s in shapes]
    with OpStats(fake_mode) as stats:
        fn(*xs)
    return stats.summary()


DOTS = {
    "mm": ({"a": "f32[8,16]", "b": "f32[16,32]"},
           "%d = f32[8,32]{1,0} dot(%a, %b), lhs_contracting_dims={1}, "
           "rhs_contracting_dims={0}",
           lambda a, b: a @ b, ((8, 16), (16, 32))),
    "batched": ({"a": "f32[4,8,16]", "b": "f32[4,16,32]"},
                "%d = f32[4,8,32]{2,1,0} dot(%a, %b), lhs_batch_dims={0}, "
                "lhs_contracting_dims={2}, rhs_batch_dims={0}, "
                "rhs_contracting_dims={1}",
                lambda a, b: torch.bmm(a, b), ((4, 8, 16), (4, 16, 32))),
    "two_contracting": ({"a": "f32[8,4,16]", "b": "f32[4,16,32]"},
                        "%d = f32[8,32]{1,0} dot(%a, %b), "
                        "lhs_contracting_dims={1,2}, "
                        "rhs_contracting_dims={0,1}",
                        lambda a, b: torch.tensordot(a, b, dims=([1, 2],
                                                                 [0, 1])),
                        ((8, 4, 16), (4, 16, 32))),
    "bias": ({"a": "f32[8,16]", "b": "f32[16,32]"},
             "%d = f32[8,32]{1,0} dot(%a, %b), lhs_contracting_dims={1}, "
             "rhs_contracting_dims={0}",
             lambda a, b: torch.nn.functional.linear(
                 a, b.T, torch.zeros(32)), ((8, 16), (16, 32))),
}


@pytest.mark.parametrize("name", sorted(DOTS))
def test_dot_flops_equal_hlo_stats(name):
    params, root, fn, shapes = DOTS[name]
    want = J_hlo.analyze(_hlo(params, root)).flops
    got = _fake_count(fn, *shapes).flops
    assert got == want > 0


def _collective_hlo(kind: str, n: int, form: str) -> str:
    groups = (f"replica_groups=[{8 // n if 8 % n == 0 else 1},{n}]<=[8]"
              if form == "iota" else
              "replica_groups={{" + ",".join(map(str, range(n))) + "}}")
    x = "f32[16,8]"
    root = {
        "all-gather": f"%c = f32[{16 * n},8]{{1,0}} all-gather(%x), "
                      f"{groups}, dimensions={{0}}",
        "all-reduce": f"%c = f32[16,8]{{1,0}} all-reduce(%x), {groups}, "
                      f"to_apply=%add",
        "reduce-scatter": f"%c = f32[{16 // n},8]{{1,0}} reduce-scatter(%x),"
                          f" {groups}, dimensions={{0}}, to_apply=%add",
        "all-to-all": f"%c = f32[16,8]{{1,0}} all-to-all(%x), {groups}, "
                      f"dimensions={{0}}",
        "collective-permute": "%c = f32[16,8]{1,0} collective-permute(%x), "
                              "source_target_pairs={{0,1},{1,0}}",
    }[kind]
    return _hlo({"x": x}, root)


def _port_collective(kind: str, n: int):
    """The same collective on a fake group of ``n`` ranks."""
    with dryrun.fake_group(n):
        group = dist.group.WORLD

        def run(x):
            if kind == "all-gather":
                funcol.all_gather_single(x, 0, group) * 1
            elif kind == "all-reduce":
                funcol.all_reduce(x, "sum", group) * 1
            elif kind == "reduce-scatter":
                funcol.reduce_scatter_single(x, "sum", 0, group) * 1
            elif kind == "all-to-all":
                funcol.all_to_all_single(x, None, None, group) * 1
            else:
                y = torch.empty_like(x)
                for req in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, x, 1 % n),
                        dist.P2POp(dist.irecv, y, (n - 1) % n)]):
                    req.wait()

        return _fake_count(run, (16, 8))


@pytest.mark.parametrize("form", ["iota", "list"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", COLLECTIVES)
def test_collectives_equal_hlo_stats(kind, n, form):
    want = J_hlo.analyze(_collective_hlo(kind, n, form))
    got = _port_collective(kind, n)
    assert got.coll_bytes == want.coll_bytes
    assert got.coll_counts == want.coll_counts
    assert got.coll_bytes[kind] > 0 and got.coll_counts[kind] == 1


def _shard_to_shard(n: int, window):
    """Shard(0) -> Shard(1) of a (16 n, 8) float32 DTensor on a fake
    group of ``n`` ranks and a ``cpu`` mesh, counted inside ``window``:
    each rank's (16, 8) shard becomes (16 n, 8 / n)."""
    with dryrun.fake_group(n):
        mesh = init_device_mesh("cpu", (n,))
        fake_mode = FakeTensorMode()
        with fake_mode:
            x = DTensor.from_local(torch.empty(16, 8), mesh, [Shard(0)],
                                   run_check=False)
        with window, OpStats(fake_mode) as stats:
            y = x.redistribute(mesh, [Shard(1)])
    assert y.to_local().shape == (16 * n, 8 // n)
    return stats.summary()


@pytest.mark.parametrize("form", ["iota", "list"])
def test_card_alltoall_equals_hlo_stats(form):
    """Inside ``card_alltoall`` a Shard->Shard redistribution on a 4-rank
    ``cpu`` mesh counts what the card's NCCL mesh sends: one all-to-all of
    the local shard, bytes and counts equal to ``hlo_stats``'s for the
    same all-to-all, and no all-gather."""
    want = J_hlo.analyze(_collective_hlo("all-to-all", 4, form))
    got = _shard_to_shard(4, dryrun.card_alltoall())
    assert got.coll_bytes == want.coll_bytes
    assert got.coll_counts == want.coll_counts
    assert got.coll_counts["all-to-all"] == 1
    assert got.coll_bytes["all-to-all"] == 16 * 8 * 4 * 3 / 4


def test_card_alltoall_is_undone_after_the_window():
    """The hook rebinds ``shard_dim_alltoall`` where DTensor looks it up
    and restores both on exit, an exception included; after it the
    ``cpu`` mesh's Shard->Shard is DTensor's own fallback again, an
    all-gather of n times the bytes and no all-to-all."""
    def bound():
        return (_collective_utils.shard_dim_alltoall,
                placement_types.shard_dim_alltoall)

    before = bound()
    with dryrun.card_alltoall():
        assert bound()[1] is not before[1]
    assert bound() == before
    with pytest.raises(RuntimeError, match="boom"):
        with dryrun.card_alltoall():
            raise RuntimeError("boom")
    assert bound() == before
    got = _shard_to_shard(4, contextlib.nullcontext())
    assert got.coll_counts == {**{c: 0.0 for c in COLLECTIVES},
                               "all-gather": 1.0}
    assert got.coll_bytes["all-gather"] == 16 * 8 * 4 * 4 * 3 / 4


def test_gloo_mesh_keeps_dtensors_own_path(procs):
    """Two gloo ranks on real tensors: inside ``card_alltoall`` and after
    an exception in it, Shard(0) -> Shard(1) gives each rank its columns
    of the whole tensor by DTensor's own path, one all-gather and no
    all-to-all (gloo has none)."""
    for rank, out in enumerate(_collect(procs["gloo"], "GLOO ")):
        for label, got in out.items():
            assert got["equal"], (rank, label)
            assert got["counts"] == {**{c: 0.0 for c in COLLECTIVES},
                                     "all-gather": 1.0}, (rank, label)


@pytest.mark.parametrize("dim_sharded", [False, True])
def test_pad_dim_pads_each_shard(dim_sharded):
    """``perf.pad_dim`` (the prefill cache's pad, which DTensor's
    ``constant_pad_nd`` cannot plan on the card's torch) on a (2, 4) fake
    group: each rank pads its own shard, the placements kept, no
    collective; a sharded pad dim is gathered whole first, one
    all-gather."""
    with dryrun.fake_group(8):
        mesh = init_device_mesh("cpu", (2, 4))
        pl = [Shard(0), Shard(1) if dim_sharded else Shard(2)]
        fake_mode = FakeTensorMode()
        with fake_mode:
            x = DTensor.from_local(torch.empty(2, 3, 4), mesh, pl,
                                   run_check=False)
        with OpStats(fake_mode) as stats:
            y = perf.pad_dim(x, 1, 5)
    assert y.shape == ((4, 12 + 5, 4) if dim_sharded else (4, 3 + 5, 16))
    want = [Shard(0), Replicate() if dim_sharded else Shard(2)]
    assert list(y.placements) == want
    assert y.to_local().shape == (2, y.shape[1], 4)
    assert stats.coll_counts == {**{c: 0.0 for c in COLLECTIVES},
                                 "all-gather": float(dim_sharded)}
    plain = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(perf.pad_dim(plain, 1, 5), torch.cat(
        [plain, torch.zeros(2, 5, 4)], 1))


def test_product_on_the_pod_counts_one_device():
    """(256, 2560) x (2560, 6912), x ``[Shard(0), Replicate()]`` and w
    ``[Replicate(), Shard(1)]`` on 16 x 16 fake ranks: one device's 16 x
    2560 x 432 product, and the result's gather over both mesh dims."""
    with dryrun.fake_group(256):
        mesh = init_device_mesh("cpu", (16, 16))
        fake_mode = FakeTensorMode()
        with fake_mode:
            x = DTensor.from_local(torch.empty(16, 2560), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            w = DTensor.from_local(torch.empty(2560, 432), mesh,
                                   [Replicate(), Shard(1)], run_check=False)
        with OpStats(fake_mode) as stats:
            (x @ w).full_tensor()
    got = stats.summary()
    assert got.flops == 2 * 16 * 2560 * 432 == 35_389_440
    assert got.coll_counts == {**{c: 0.0 for c in COLLECTIVES},
                               "all-gather": 2.0}


def test_h100_rates():
    assert roofline.H100 == roofline.Hardware(989e12, 3.35e12, 50e9)


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------


def test_run_cell_leaves_no_group_after_a_failure(monkeypatch):
    def boom(*a, **kw):
        assert dist.is_initialized() and dist.get_world_size() == 256
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "cell_stats", boom)
    with pytest.raises(RuntimeError, match="boom"):
        dryrun.run_cell("qwen1.5-4b", "decode_32k", multi_pod=False)
    assert not dist.is_initialized()


def test_run_cell_refuses_under_a_group():
    with dryrun.fake_group(1):
        with pytest.raises(RuntimeError, match="already initialised"):
            dryrun.run_cell("qwen1.5-4b", "decode_32k", multi_pod=False)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# one full-width cell
# ---------------------------------------------------------------------------


def test_full_width_decode_cell():
    """qwen1.5-4b x decode_32k on the 16 x 16 pod at full width and depth:
    the arguments' bytes equal the rules' local shards of the real
    leaves (``rules.local_shape`` on a ``MeshShape``, not DTensor's own
    split), and the useful ratio lies within (0.05, 1]."""
    rec = dryrun.run_cell("qwen1.5-4b", "decode_32k", multi_pod=False)
    assert not dist.is_initialized()
    assert "error" not in rec and rec["n_devices"] == 256
    cfg, shape = get_config("qwen1.5-4b"), SHAPES["decode_32k"]
    pod = MeshShape(("data", "model"), (16, 16))
    params = get_model(cfg).init_params(cfg, 0, device="meta")
    structs = (params, ST.input_specs(cfg, shape))
    want = 0
    for tree, specs in zip(structs, ST.input_shardings(cfg, pod, "decode",
                                                       structs)):
        leaf_specs = rules.spec_leaves(specs, tree)
        want += sum(math.prod(rules.local_shape(t.shape, leaf_specs[n], pod))
                    * t.element_size() for n, t in flatten_with_path(tree))
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    assert rec["memory_analysis"]["alias_size_in_bytes"] > 0
    row = roofline.roofline_row(roofline._enrich(dict(rec)))
    print(f"qwen1.5-4b x decode_32k x pod16x16: traced in {rec['trace_s']} "
          f"s; flops/device {rec['flops_per_device']:.4e}, collective "
          f"bytes/device {rec['total_collective_bytes']:.4e}, useful "
          f"{row['useful_ratio']:.4f}")
    assert 0.05 < row["useful_ratio"] <= 1.0


# ---------------------------------------------------------------------------
# should_skip and the record's config fields
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skip_reasons_and_meta_equal_the_reference(ref, arch):
    cfg = get_config(arch)
    for s, shape in SHAPES.items():
        assert dryrun.should_skip(cfg, shape) == ref["skip"][f"{arch}|{s}"]
    assert {"params": cfg.param_count(),
            "active_params": cfg.active_param_count()} == ref["meta"][arch]
    assert {s: [sh.kind, sh.seq_len, sh.global_batch]
            for s, sh in SHAPES.items()} == ref["shapes"]


def test_skipped_record_has_the_reference_keys():
    rec = dryrun.run_cell("qwen1.5-4b", "long_500k", multi_pod=False)
    shape = SHAPES["long_500k"]
    assert rec == {
        "arch": "qwen1.5-4b", "shape": "long_500k", "mesh": "pod16x16",
        "variant": "baseline", "kind": shape.kind,
        "params": get_config("qwen1.5-4b").param_count(),
        "active_params": get_config("qwen1.5-4b").active_param_count(),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "skipped": dryrun.should_skip(get_config("qwen1.5-4b"), shape)}
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# smoke cells against the reference's compiled HLO
# ---------------------------------------------------------------------------


def _whisper_unread_bytes(mesh) -> int:
    """Rank 0's bytes, by the rules on ``mesh`` (a ``MeshShape``), of the
    whisper parameters a decode step does not read: the encoder, its
    input projection and final norm, and the cross-attention K/V
    projections (the cache holds the encoder's K/V).  ``jax.jit`` prunes
    unused arguments, so the reference's arguments leave them out."""
    cfg = get_smoke_config("whisper-large-v3")
    params = get_model(cfg).init_params(cfg, 0, device="meta")
    shape = ShapeConfig("decode", 32, 8, "decode")
    structs = (params, ST.input_specs(cfg, shape))
    specs = rules.spec_leaves(
        ST.input_shardings(cfg, mesh, "decode", structs)[0], params)
    unread = ("encoder/", "enc_in", "enc_final_norm/", "decoder/xattn/wk",
              "decoder/xattn/wv")
    return sum(math.prod(rules.local_shape(t.shape, specs[n], mesh))
               * t.element_size() for n, t in flatten_with_path(params)
               if n.startswith(unread))


def _whisper_train_excess() -> float:
    """The port's whisper train flops above three quarters of the
    reference's at 1 x 1: the encoder's input projection (8 rows x
    ``cross_kv_len`` frames x d x d) takes no gradient for its input, the
    frames, so its backward costs one forward, not two, and the
    reference computes its forward once for the loss and the linearized
    copy (the one product, ``jvp`` by op_name, that its ``primal`` split
    lacks): it counts that product twice, three quarters of which is 1.5,
    where the port counts it twice."""
    cfg = get_smoke_config("whisper-large-v3")
    return 0.5 * 2 * 8 * cfg.cross_kv_len * cfg.d_model * cfg.d_model


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", SMOKE)
def test_smoke_1x1(ref, port, arch, kind):
    """On one device every dot of the step is counted once.  Prefill and
    decode equal the reference's dot flops.  The reference's compiled
    train step runs its layer scan's forward twice, once for the loss and
    once linearized for the backward (its dots' op_names: qwen1.5-4b's
    ``primal`` and ``jvp`` splits are equal), and every dot's backward
    costs twice its forward: it counts 4 forwards' flops.  The port runs
    the forward once (autograd keeps what the backward needs), 3
    forwards' flops: three quarters of the reference's, exactly.  The
    gap and the reference's split by op_name are printed.  The arguments'
    bytes are equal and there is no collective.  One arch departs:
    whisper's train counts :func:`_whisper_train_excess` more, and its
    decode step's arguments hold the parameters it does not read
    (:func:`_whisper_unread_bytes`), which the reference prunes."""
    r, p = ref["cells"][f"{arch}|{kind}|1x1"], port[f"{arch}|{kind}|1x1"]
    got = p["flops_per_device"]
    whisper = arch == "whisper-large-v3"
    if kind == "train":
        print(f"{arch} train 1x1: port {got:.0f}, reference {r['flops']:.0f}"
              f" (by op_name {r['split']}); gap "
              f"{(r['flops'] - got) / r['flops']:.4f} of the reference")
        assert got - 0.75 * r["flops"] == (
            _whisper_train_excess() if whisper else 0)
    else:
        assert got == r["flops"]
    arg = p["memory_analysis"]["argument_size_in_bytes"]
    unread = _whisper_unread_bytes(MeshShape(AXES, (1, 1))) \
        if whisper and kind == "decode" else 0
    assert arg - r["arg"] == unread
    assert p["total_collective_bytes"] == r["coll"] == 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_2x4(ref, port, arch, kind):
    """The (2, 4) mesh: every cell counts; the arguments' bytes equal the
    reference's (whisper's decode step: but for the local shards of the
    parameters it does not read, ``test_smoke_1x1``); collectives present
    where the reference has them, and the MoE archs' train and prefill
    with the all-to-alls of their expert combine, within ``A2A_REL`` of
    the reference's collective bytes.  Train: the port's per-device flops are
    its 1 x 1 flops over the 8 devices exactly (no work replicated), for
    the archs without a 1 x 1 gap three quarters of the reference's 1 x 1
    count spread evenly (``test_smoke_1x1``); the reference's own (2, 4)
    count is printed beside it, with its split by op_name (GSPMD shards
    its loss forward less evenly than the linearized copy).  Prefill and
    decode flops per device within 10% of the reference's, less, for the
    Mamba2 hybrid, its 1 x 1 gap spread over the 8 devices
    (``test_recurrence_and_branch_gaps``).  rwkv's reference repeats part
    of its prefill and decode work on this mesh (its (2, 4) count x 8
    exceeds its 1 x 1 count); the port's count is then held to its own
    1 x 1 count over the 8 devices, no work replicated.  No cell counts
    more collective bytes than ``COLL_CEIL``."""
    r, p = ref["cells"][f"{arch}|{kind}|2x4"], port[f"{arch}|{kind}|2x4"]
    got = p["flops_per_device"]
    one = port[f"{arch}|{kind}|1x1"]["flops_per_device"]
    r1 = ref["cells"][f"{arch}|{kind}|1x1"]["flops"]
    print(f"{arch} {kind} 2x4: port flops/device {got:.0f}, reference "
          f"{r['flops']:.0f}; collective bytes port "
          f"{p['total_collective_bytes']:.0f}, reference {r['coll']:.0f}; "
          f"counts port {p['collective_counts']}, reference {r['counts']}")
    assert "error" not in p and p["n_devices"] == 8
    unread = _whisper_unread_bytes(MeshShape(AXES, (2, 4))) \
        if arch == "whisper-large-v3" and kind == "decode" else 0
    assert p["memory_analysis"]["argument_size_in_bytes"] - r["arg"] \
        == unread
    if kind == "train":
        print(f"  split of the reference's (2, 4) dots: {r['split']}")
        assert got * 8 == one
        if arch in ("gemma-2b", "gemma3-1b", "qwen1.5-4b", "qwen3-14b",
                    "arctic-480b", "qwen3-moe-235b-a22b", "internvl2-26b"):
            assert one == 0.75 * r1
    elif arch == "rwkv6-3b":
        print(f"  reference (2, 4) x 8 / 1 x 1: {r['flops'] * 8 / r1:.4f}")
        assert r["flops"] * 8 > r1
        assert got * 8 == one
    else:
        want = r["flops"]
        if arch == "zamba2-7b":
            want -= (r1 - one) / 8
        assert abs(got - want) <= FLOPS_REL * want
    assert p["total_collective_bytes"] > 0 and r["coll"] > 0
    if arch in MOE and kind != "decode":
        assert p["collective_counts"]["all-to-all"] > 0
        assert p["total_collective_bytes"] <= A2A_REL * r["coll"]
    assert p["total_collective_bytes"] <= COLL_CEIL[f"{arch}|{kind}"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_to_shard_counts_all_to_all(counted_parts, arch, kind):
    """On every mesh of the smoke cells, a cell counts all-to-alls exactly
    when DTensor redistributed Shard->Shard in it
    (``Shard._to_new_shard_dim``): the card's collective, not the ``cpu``
    mesh's all-gather fallback (``dryrun.card_alltoall``)."""
    cells, moves, _ = counted_parts
    keys = [k for k in moves if k.startswith(f"{arch}|{kind}|")]
    assert keys
    for key in keys:
        a2a = cells[key]["collective_counts"]["all-to-all"]
        print(f"{key}: {moves[key]} Shard->Shard, {a2a:.0f} all-to-all")
        assert (moves[key] > 0) == (a2a > 0), key


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_index_writes_have_replicated_operands(counted_parts, arch, kind):
    """Every index write (``aten.index_put*``) that reaches DTensor's
    dispatch in a smoke cell, on every mesh, has only replicated DTensor
    operands: the class of the card's torch's faults, which this torch
    plans without failing (the embedding's backward met a ``Shard`` in
    the card's ``prop_index_put``; the MoE gathers' backward wrote rows
    past a shard on its gloo ranks).  A sharded lookup or gather goes
    through ``sharding.perf.local_embedding``/``local_gather``, whose
    writes are on local tensors.  The MoE cells' dispatch write is seen,
    so the guard is not empty."""
    _, _, writes = counted_parts
    keys = [k for k in writes if k.startswith(f"{arch}|{kind}|")]
    assert keys
    for key in keys:
        bad = [w for w in writes[key] if any(p != "R" for p in w[1])]
        print(f"{key}: {len(writes[key])} index writes, {len(bad)} with a "
              f"sharded operand {bad[:2]}")
        assert not bad, key
    if arch in MOE:
        assert writes[f"{arch}|{kind}|2x4"], arch


def test_watch_sees_dtensor_ops_inside_the_window_only():
    """``OpStats(watch=...)``, the hook ``cell_stats`` passes on: inside
    the window it sees an index write of a DTensor with its operands;
    after the window, and after an exception in it, it sees nothing."""
    seen = []

    def watch(func, args, kwargs):
        seen.append(func.overloadpacket.__name__)

    with dryrun.fake_group(2):
        mesh = init_device_mesh("cpu", (2,))
        fake_mode = FakeTensorMode()
        with fake_mode:
            x = DTensor.from_local(torch.empty(4, 3), mesh, [Replicate()],
                                   run_check=False)
            idx, val = (DTensor.from_local(t, mesh, [Replicate()],
                                           run_check=False)
                        for t in (torch.tensor([0, 2]), torch.empty(2, 3)))

        def write():
            return x.index_put((idx,), val)

        with OpStats(fake_mode, watch=watch):
            write()
        assert "index_put" in seen
        n = len(seen)
        with fake_mode:
            write()
        with pytest.raises(RuntimeError, match="boom"):
            with OpStats(fake_mode, watch=watch):
                raise RuntimeError("boom")
        with fake_mode:
            write()
    assert len(seen) == n


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", POD_ARCHS)
def test_smoke_pod_mesh(ref, port, arch, kind):
    """The three axes of the two-pod mesh, ``("pod", "data", "model")``,
    at 2 x 2 x 2: the cell counts on 8 devices, the arguments' bytes equal
    the reference's, and collectives appear exactly where the
    reference's have them, no more collective bytes than ``POD_CEIL``;
    the flops are printed beside the reference's."""
    r, p = ref["cells"][f"{arch}|{kind}|2x2x2"], port[f"{arch}|{kind}|2x2x2"]
    print(f"{arch} {kind} 2x2x2: port flops/device "
          f"{p['flops_per_device']:.0f}, reference {r['flops']:.0f}; "
          f"collective bytes port {p['total_collective_bytes']:.0f}, "
          f"reference {r['coll']:.0f}")
    assert "error" not in p and p["n_devices"] == 8
    assert p["memory_analysis"]["argument_size_in_bytes"] == r["arg"]
    assert (p["total_collective_bytes"] > 0) == (r["coll"] > 0)
    assert p["total_collective_bytes"] <= POD_CEIL[f"{arch}|{kind}"]


def _branch_flops(cfg, b, s, kv_len) -> float:
    """Dot flops of one application of zamba2's shared attention + MLP
    block on (b, s) tokens against ``kv_len`` key positions."""
    d, h, kv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    proj = 2 * b * s * d * (2 * h * hd + 2 * kv * hd)
    mlp = 3 * 2 * b * s * d * ff
    attn = 2 * 2 * b * h * s * kv_len * hd
    return proj + mlp + attn


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrence_and_branch_gaps(ref, port, arch, kind):
    """The two departures of ``op_stats``'s docstring, held from the
    shapes (B = 8, S = 32, L layers).

    rwkv: the reference's recurrence einsums are dots to XLA.  Per layer
    and chunk of C positions, ``bthd,bshd,btshd->bhts`` contracts dk:
    2·B·H·C·C·dk; the current-token bonus ``bthd,hd,bthd,bthv->bthv``
    contracts dk once a position: 2·B·S·H·dk (in decode, one position:
    2·B·H·dk, and no chunk).  The port writes both as products and sums.

    zamba2: the reference counts its per-layer conditional at the larger
    branch, the shared attention + MLP block on every layer, where the
    port counts the layers that take it (i % attn_every == attn_every -
    1); and Mamba2's ``bthd,bshd,btshd->bhts`` contracts the state
    (2·B·H·C·C·st a layer in prefill, C = min(64, S)).

    Train: the reference counts each of those forward gaps G four times
    (``test_smoke_1x1``), and its transpose of a one-chunk loop (S = 32 is
    one chunk for both) holds one more product of B·H·C·C·dk a layer
    (dk: the state, st, for Mamba2; at three chunks its transpose is
    exactly twice its forward); the port's train flops fall short of
    three quarters of the reference's by 3·G plus three quarters of
    that."""
    cfg = get_smoke_config(arch)
    b, s, n_layers = 8, 32, cfg.n_layers
    r, p = ref["cells"][f"{arch}|{kind}|1x1"], port[f"{arch}|{kind}|1x1"]
    fwd = "prefill" if kind == "train" else kind
    if cfg.rwkv:
        h, dk = cfg.n_heads, cfg.d_model // cfg.n_heads
        c = min(32, s)
        if fwd == "prefill":
            want = n_layers * (-(-s // c) * 2 * b * h * c * c * dk
                               + 2 * b * s * h * dk)
        else:
            want = n_layers * 2 * b * h * dk
    else:
        h, dk = cfg.ssm_heads, cfg.ssm_state
        c = min(64, s)
        apps = sum(1 for i in range(n_layers)
                   if i % cfg.attn_every == cfg.attn_every - 1)
        if fwd == "prefill":
            want = ((n_layers - apps) * _branch_flops(cfg, b, s, s)
                    + n_layers * -(-s // c) * 2 * b * h * c * c * dk)
        else:
            want = (n_layers - apps) * _branch_flops(cfg, b, 1, s)
    if kind == "train":
        gap = 0.75 * r["flops"] - p["flops_per_device"]
        want = 3 * want + 0.75 * n_layers * b * h * c * c * dk
    else:
        gap = r["flops"] - p["flops_per_device"]
    print(f"{arch} {kind}: reference {r['flops']:.0f}, port "
          f"{p['flops_per_device']:.0f}, gap {gap:.0f}, from the shapes "
          f"{want:.0f}")
    assert gap == want > 0
    assert p["memory_analysis"]["argument_size_in_bytes"] == r["arg"]


@pytest.mark.parametrize("kind", UNEVEN_KINDS)
def test_uneven_heads_split_as_padded(ref, port, kind):
    """rwkv's smoke prefill and decode on a ``model`` dim of 8 over its 4
    heads, which the mesh divides neither: each rank runs its share of
    the heads padded to a multiple of 8, ceil(4 / 8) = 1, as GSPMD does,
    where every rank ran all 4.  Every other product divides the 8 ranks
    (``contract_model``), so the per-device flops are the 1 x 1 count
    split over 8, but for the recurrence's dots, split over the padded
    heads: per layer and chunk of C positions ``a @ v`` 2·B·H·C·C·dv, the
    carry-in and the state's update 2·B·H·C·dk·dv each (in decode one
    position: ``r @ state``, 2·B·H·dk·dv).  No more than the reference's
    count on the same mesh, within ``FLOPS_REL``."""
    cfg = get_smoke_config("rwkv6-3b")
    b, s, n = 8, 32, UNEVEN["1x8"][1]
    h = cfg.n_heads
    dk = dv = cfg.d_model // h
    c = min(32, s)
    if kind == "prefill":
        rec = -(-s // c) * (2 * b * h * c * c * dv + 2 * 2 * b * h * c * dk * dv)
    else:
        rec = 2 * b * h * dk * dv
    rec *= cfg.n_layers
    one = port[f"rwkv6-3b|{kind}|1x1"]["flops_per_device"]
    got = port[f"rwkv6-3b|{kind}|1x8"]["flops_per_device"]
    r = ref["cells"][f"rwkv6-3b|{kind}|1x8"]["flops"]
    want = (one - rec) / n + rec * -(-h // n) / h
    print(f"rwkv6-3b {kind} 1x8: port {got:.0f}, from the 1 x 1 count "
          f"{want:.0f} (recurrence {rec:.0f} of {one:.0f}), reference "
          f"{r:.0f}")
    assert got == want
    assert got <= r * (1 + FLOPS_REL)


def test_two_pods_split_the_experts(counted):
    """arctic's experts on the two pods (``POD_CELL``, prefill_32k's
    token count): ``w_down``'s contraction is split over ``pod`` and
    ``data`` as the weight is (``contract_like``), so the cell counts
    exactly half of its one-pod flops per device; before, every ``data``
    rank ran the whole down product (prefill_32k: 3.242e14 against
    2.736e14)."""
    one = counted["arctic-480b|prefill|pod16x16|experts"]
    two = counted["arctic-480b|prefill|pod2x16x16|experts"]
    print(f"arctic-480b {POD_CELL}: pod16x16 {one['flops_per_device']:.6e} "
          f"flops/device in {one['trace_s']} s, pod2x16x16 "
          f"{two['flops_per_device']:.6e} in {two['trace_s']} s")
    assert one["n_devices"] == 256 and two["n_devices"] == 512
    assert two["flops_per_device"] * 2 == one["flops_per_device"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", RECURRENT)
def test_trip_weighting_counts_every_step(counted, arch, mesh):
    """On fake tensors the dry-run runs one of a train step's microbatches
    and counts it for all of them (``op_stats.trips``), and a middle chunk
    of the recurrence for the n - 2 between the first and the last
    (``op_stats.scan``, ``test_scan_counts_every_chunk``), as
    ``hlo_stats`` weights a while body.  The recurrent smoke configs'
    train step at 2 microbatches: every field of the record but the trace
    time equals the count of every microbatch (flops, HBM bytes,
    collectives, arguments, outputs and the peak of live storage)."""
    got = dict(counted[f"{arch}|train|{mesh}"])
    want = dict(counted[f"{arch}|train|{mesh}|every step"])
    print(f"{arch} train {mesh}: traced in {got.pop('trace_s')} s "
          f"weighted, {want.pop('trace_s')} s every step")
    assert got == want
    assert got["flops_per_device"] > 0 and got["microbatches"] == 2


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("bonus", [False, True])
def test_scan_counts_every_chunk(bonus, grad):
    """``chunked_decay_recurrence`` over 6 chunks on fake tensors, rwkv's
    (``u``) and Mamba2's, forward and with its backward: the count that
    runs the first, a middle and the last chunk and weights the middle
    equals the count of every chunk, flops, HBM bytes and the peak of
    live storage, to the byte."""
    from repro_torch.models.recurrent import chunked_decay_recurrence

    fake_mode = FakeTensorMode()
    with fake_mode:
        r, k, v, lw = (torch.empty(2, 6 * 8, 3, 4, requires_grad=grad)
                       for _ in range(4))
        u = torch.empty(3, 4, requires_grad=grad) if bonus else None
    counts = []
    for weighting in (True, False):
        with OpStats(fake_mode, trip_weighting=weighting) as stats:
            y, state = chunked_decay_recurrence(r, k, v, lw, u=u, chunk=8)
            assert y.shape == (2, 48, 3, 4) and state.shape == (2, 3, 4, 4)
            if grad:
                wrt = [r, k, v, lw] + ([u] if bonus else [])
                torch.autograd.grad((y.sum(), state.sum()), wrt)
        counts.append((stats.flops, stats.hbm_bytes, stats.peak_bytes))
    assert counts[0] == counts[1] and counts[0][0] > 0


def test_roofline_equals_the_reference(port):
    hw = roofline.Hardware(J_roof.PEAK_FLOPS, J_roof.HBM_BW, J_roof.ICI_BW)
    recs = [dict(r) for r in port.values()]
    recs += [{"arch": "gemma-2b", "shape": "train_4k", "mesh": "pod16x16",
              "error": "RuntimeError: boom", "traceback": "..."},
             {"arch": "qwen1.5-4b", "shape": "long_500k",
              "mesh": "pod16x16", "skipped": "no"},
             {"arch": "not-an-arch", "kind": "decode"}]
    rows_p, rows_j = [], []
    for rec in recs:
        e_p, e_j = roofline._enrich(dict(rec)), J_roof._enrich(dict(rec))
        assert e_p == e_j
        if "flops_per_device" not in rec and "error" not in rec \
                and "skipped" not in rec:
            continue
        row_p, row_j = roofline.roofline_row(e_p, hw), \
            J_roof.roofline_row(e_j)
        assert row_p == row_j
        if row_p is not None:
            assert roofline.model_flops(e_p) == J_roof.model_flops(e_j)
            assert roofline.analytic_memory_bytes(e_p) == \
                J_roof.analytic_memory_bytes(e_j)
            rows_p.append(row_p)
            rows_j.append(row_j)
    assert rows_p and len(rows_p) == len(rows_j)
    for mesh in ("1x1", "2x4"):
        assert roofline.format_table(rows_p, mesh) == \
            J_roof.format_table(rows_j, mesh)
