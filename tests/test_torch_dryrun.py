"""The port's dry-run tooling (``repro_torch.launch.op_stats``, ``dryrun``,
``roofline``) against the reference's (``repro.launch.hlo_stats``,
``dryrun``, ``roofline``) on the CPU.

The reference's compiled cells run in one JAX subprocess on 8 host
devices (``--xla_force_host_platform_device_count=8``, as
``tests/test_distribution.py`` runs its meshes): importing
``repro.launch.dryrun`` rewrites ``XLA_FLAGS`` to 512 devices, which
must not reach this process's later JAX tests.  ``hlo_stats`` and
``roofline`` are plain Python and are imported here.  The port's cells
run here on a fake process group (``dryrun.fake_group``) over fake
tensors.

* ``should_skip`` and the record's config fields equal the reference's
  for every (arch, shape).
* ``op_stats`` against ``hlo_stats.analyze`` with ``==``: dots (batched,
  two contracting dims, with a bias) on hand-written HLO and the same
  products on fake tensors; each of the five collective kinds at 2, 4
  and 8 ranks in both ``replica_groups`` forms against the same
  collective on a fake group.
* The 16 x 16 product counts one device's flops and two all-gathers.
* gemma-2b and qwen1.5-4b smoke, ``ShapeConfig(kind, 32, 8, kind)``,
  train at 2 microbatches, against the reference's compiled HLO: on a
  1 x 1 mesh prefill and decode flops equal, train three quarters of
  the reference's (its forward runs twice, ``test_smoke_1x1``);
  on the (2, 4) mesh the arguments' bytes equal, prefill and decode
  flops within 10%, train flops exactly the 1 x 1 count over 8, and
  collectives present exactly where the reference has them.
* zamba2 and rwkv smoke: the flops gap to the reference, from the shapes.
* The roofline's functions equal the reference's on the same records.
* ``run_cell`` leaves no process group and refuses under one.
* qwen1.5-4b x decode_32k at full width on the 16 x 16 pod: the
  arguments' bytes equal the rules' local shards of the real leaves.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

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
from repro_torch.sharding import rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ("gemma-2b", "qwen1.5-4b")
KINDS = ("train", "prefill", "decode")
MESHES = {"1x1": (1, 1), "2x4": (2, 4)}
RECURRENT = ("zamba2-7b", "rwkv6-3b")
FLOPS_REL = 0.10            # the (2, 4) mesh's flops against the reference

REF_BODY = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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


def cell(arch, kind, dims):
    devs = np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims)
    mesh = jax.sharding.Mesh(devs, ("data", "model"))
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
for a in SMOKE:
    for kind in KINDS:
        for name, dims in MESHES.items():
            out["cells"][f"{a}|{kind}|{name}"] = cell(a, kind, dims)
for a in RECURRENT:
    for kind in ("prefill", "decode"):
        out["cells"][f"{a}|{kind}|1x1"] = cell(a, kind, (1, 1))
print("REF " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref_proc():
    """The reference's side, started at once so that it runs beside the
    port's cells."""
    code = (f"SMOKE, KINDS, RECURRENT = {SMOKE!r}, {KINDS!r}, "
            f"{RECURRENT!r}\nMESHES = {MESHES!r}\n" + REF_BODY)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ref(ref_proc):
    out, err = ref_proc.communicate(timeout=600)
    lines = [ln for ln in out.splitlines() if ln.startswith("REF ")]
    assert ref_proc.returncode == 0 and lines, err[-4000:]
    return json.loads(lines[-1][4:])


def _cell_record(arch, kind, cfg, mesh_name, stats) -> dict:
    """A port record of a smoke cell, with the meta keys of
    ``run_cell``'s."""
    return {"arch": arch, "shape": f"smoke_{kind}", "mesh": mesh_name,
            "variant": "baseline", "kind": kind,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(), "seq_len": 32,
            "global_batch": 8, **stats}


@pytest.fixture(scope="module")
def port(ref_proc):
    """The port's smoke cells: {"arch|kind|mesh": record}."""
    out = {}
    for name, dims in MESHES.items():
        with dryrun.fake_group(dims[0] * dims[1]):
            mesh = make_debug_mesh(*dims, device_type="cpu")
            archs = SMOKE + (RECURRENT if name == "1x1" else ())
            for arch in archs:
                cfg = get_smoke_config(arch)
                kinds = KINDS if arch in SMOKE else ("prefill", "decode")
                for kind in kinds:
                    stats = dryrun.cell_stats(
                        cfg, ShapeConfig(kind, 32, 8, kind), mesh,
                        microbatches=2 if kind == "train" else None)
                    out[f"{arch}|{kind}|{name}"] = _cell_record(
                        arch, kind, cfg, name, stats)
    return out


# ---------------------------------------------------------------------------
# should_skip and the record's config fields
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skip_reasons_and_meta_equal_the_reference(port, ref, arch):
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


# ---------------------------------------------------------------------------
# smoke cells against the reference's compiled HLO
# ---------------------------------------------------------------------------


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
    gap and the reference's split by op_name are printed."""
    r, p = ref["cells"][f"{arch}|{kind}|1x1"], port[f"{arch}|{kind}|1x1"]
    got = p["flops_per_device"]
    if kind == "train":
        print(f"{arch} train 1x1: port {got:.0f}, reference {r['flops']:.0f}"
              f" (by op_name {r['split']}); gap "
              f"{(r['flops'] - got) / r['flops']:.4f} of the reference")
        assert got == 0.75 * r["flops"]
    else:
        assert got == r["flops"]
    assert p["memory_analysis"]["argument_size_in_bytes"] == r["arg"]
    assert p["total_collective_bytes"] == r["coll"] == 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", SMOKE)
def test_smoke_2x4(ref, port, arch, kind):
    """The (2, 4) mesh: the arguments' bytes equal the reference's;
    prefill and decode flops per device within 10% of the reference's;
    collectives present where the reference has them.  Train: the port's
    per-device flops are its 1 x 1 flops over the 8 devices exactly (no
    work replicated), three quarters of the reference's 1 x 1 count
    spread evenly (``test_smoke_1x1``); the reference's own (2, 4) count
    is printed beside it, with its split by op_name (GSPMD shards its
    loss forward less evenly than the linearized copy)."""
    r, p = ref["cells"][f"{arch}|{kind}|2x4"], port[f"{arch}|{kind}|2x4"]
    got = p["flops_per_device"]
    print(f"{arch} {kind} 2x4: port flops/device {got:.0f}, reference "
          f"{r['flops']:.0f}; collective bytes port "
          f"{p['total_collective_bytes']:.0f}, reference {r['coll']:.0f}; "
          f"counts port {p['collective_counts']}, reference {r['counts']}")
    assert p["memory_analysis"]["argument_size_in_bytes"] == r["arg"]
    assert p["n_devices"] == 8
    if kind == "train":
        one = port[f"{arch}|train|1x1"]["flops_per_device"]
        r1 = ref["cells"][f"{arch}|train|1x1"]
        print(f"  split of the reference's (2, 4) dots: {r['split']}")
        assert got * 8 == one == 0.75 * r1["flops"]
    else:
        assert abs(got - r["flops"]) <= FLOPS_REL * r["flops"]
    assert p["total_collective_bytes"] > 0 and r["coll"] > 0


def _branch_flops(cfg, b, s, kv_len) -> float:
    """Dot flops of one application of zamba2's shared attention + MLP
    block on (b, s) tokens against ``kv_len`` key positions."""
    d, h, kv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    proj = 2 * b * s * d * (2 * h * hd + 2 * kv * hd)
    mlp = 3 * 2 * b * s * d * ff
    attn = 2 * 2 * b * h * s * kv_len * hd
    return proj + mlp + attn


@pytest.mark.parametrize("kind", ["prefill", "decode"])
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
    (2·B·H·C·C·st a layer in prefill, C = min(64, S))."""
    cfg = get_smoke_config(arch)
    b, s, n_layers = 8, 32, cfg.n_layers
    r, p = ref["cells"][f"{arch}|{kind}|1x1"], port[f"{arch}|{kind}|1x1"]
    gap = r["flops"] - p["flops_per_device"]
    if cfg.rwkv:
        h, dk = cfg.n_heads, cfg.d_model // cfg.n_heads
        if kind == "prefill":
            c = min(32, s)
            want = n_layers * (-(-s // c) * 2 * b * h * c * c * dk
                               + 2 * b * s * h * dk)
        else:
            want = n_layers * 2 * b * h * dk
    else:
        apps = sum(1 for i in range(n_layers)
                   if i % cfg.attn_every == cfg.attn_every - 1)
        if kind == "prefill":
            c = min(64, s)
            want = ((n_layers - apps) * _branch_flops(cfg, b, s, s)
                    + n_layers * -(-s // c) * 2 * b * cfg.ssm_heads * c * c
                    * cfg.ssm_state)
        else:
            want = (n_layers - apps) * _branch_flops(cfg, b, 1, s)
    print(f"{arch} {kind}: reference {r['flops']:.0f}, port "
          f"{p['flops_per_device']:.0f}, gap {gap:.0f}, from the shapes "
          f"{want:.0f}")
    assert gap == want > 0


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


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
