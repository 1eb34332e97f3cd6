"""Scale-out on a CPU mesh: multi-process gloo groups of the port's
``launch``, ``sharding``, ``optim.compress`` and ``sweep.dispatch``
(the counterpart of ``tests/test_distribution.py``, which runs the
reference on an 8-device host mesh).

Each case is a job of its own ranks (``repro_torch.launch.gloo_jobs``,
which ``chip_smoke.py``'s phase DR4v also runs): one ``python -c``
process per rank, importing only the port, in a ``gloo`` group over a
``file://`` store
(``init_process_group(timeout=60 s)``), under its own wall limit after
which every rank is killed, so a mismatched collective fails the case
instead of hanging the suite.  The jobs start together when the first
case asks for one, at most ``MAX_RANKS`` processes at a time, and each
case waits for its own.  Unless stated, a job is a 2 x 2 ``("data",
"model")`` mesh (4 ranks).

* The sharded train step (qwen3-14b smoke, 2 microbatches) against the
  port's unsharded step: loss and grad norm within 1e-5 relative, every
  parameter within the reference's 5e-3 (the worst of each printed).
* ``build_step`` on gemma-2b, arctic-480b, zamba2-7b, rwkv6-3b and
  whisper-large-v3 for train, prefill and decode, one step against the
  port's unsharded step: loss and grad norm (train) and logits and caches
  (prefill, decode) within 1e-5 relative, greedy tokens equal; rwkv6-3b
  also on a (1, 3) mesh (3 ranks), whose ``model`` dim splits its 4
  heads unevenly (padded to 6), and qwen3-14b's decode attention at 8
  heads over 2 KV heads on the same mesh; zamba2-7b on a (2, 3) mesh (6
  ranks) at 3 rows, split evenly by heads over ``data``, then padded
  over ``model``.
* Every ``perf.VARIANTS`` entry on qwen3-14b and both MoE smoke configs:
  prefill logits within 1e-5 relative of ``baseline``'s.
* RoPE's rotate-half on a ``model``-sharded q (heads, and within heads)
  equals the unsharded result to the bit: the ``spmd-concat`` class.
* ``ring_allreduce_int8`` at 3 and 4 ranks equals the reference's
  ``shard_map`` ring to the bit on the same numpy payloads (the reference
  in a JAX subprocess with ``--xla_force_host_platform_device_count``),
  and is within the reference's 0.05 relative of a plain ``all_reduce``
  mean.
* A ``run_sweep`` grid on a 4-rank 1-D ``data`` mesh equals the serial
  run metric for metric: a group whose points divide the mesh (points
  split), one whose points do not (trials split) and one where neither
  divides (every rank runs the group).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.launch.gloo_jobs import (MODEL_HELPERS, PARAM_ATOL, REL,
                                         Job as _Job, Runner,
                                         arch_body as _arch_body,
                                         result as _result)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
MAX_RANKS = 12             # processes of all jobs at once
RING_REL = 0.05            # the reference's bound against psum / n


TRAIN_BODY = MODEL_HELPERS + textwrap.dedent("""
    from repro_torch.sharding.rules import opt_state_shardings
    cfg = get_smoke_config("qwen3-14b")
    out = train_case(cfg)
    # the returned state sits where the rules put it
    shape = ShapeConfig("train", S, B, "train")
    fn, (state_struct, _) = build_step(cfg, MESH, shape, microbatches=2)
    batch = SyntheticLM(cfg, S, B, seed=0, device="cpu").batch(0)
    s2, _ = fn(make_train_state(cfg, 0, device="cpu"), batch)
    out["placed"] = placed_as_rules(
        s2, opt_state_shardings(cfg, state_struct, MESH))
    report(**out)
    """)

VARIANTS_BODY = MODEL_HELPERS + textwrap.dedent("""
    from repro_torch.sharding import perf
    out = {}
    for arch in ("qwen3-14b", "qwen3-moe-235b-a22b", "arctic-480b"):
        cfg = get_smoke_config(arch)
        params = get_model(cfg).init_params(cfg, 0, device="cpu")
        toks, kw = inputs(cfg)
        base, res = None, {}
        for name in perf.VARIANTS:
            with perf.variant(name):
                fn, _ = build_step(cfg, MESH,
                                   ShapeConfig("prefill", S, B, "prefill"))
                lg, _ = fn(params, {"tokens": toks, **kw})
            lg = full(lg)
            base = lg if base is None else base
            res[name] = rel(lg, base)
        out[arch] = res
    report(**out)
    """)

ROPE_BODY = MODEL_HELPERS + textwrap.dedent("""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models.layers import rope
    g = torch.Generator().manual_seed(5)
    q = torch.randn((4, 8, 4, 16), generator=g)
    pos = torch.arange(8)
    want = rope(q, pos, 10000.0)
    half = q.shape[-1] // 2
    want_cat = torch.cat([-q[..., half:], q[..., :half]], dim=-1)
    out = {}
    for label, pl in (("heads", [Shard(0), Shard(2)]),
                      ("within_heads", [Shard(0), Shard(3)]),
                      ("seq", [Replicate(), Shard(1)])):
        qd = distribute_tensor(q, MESH, pl)
        with implicit_replication():
            got = full(rope(qd, pos, 10000.0))
        cat = full(torch.cat([-qd[..., half:], qd[..., :half]], dim=-1))
        out[label] = {"rope": bool(torch.equal(got, want)),
                      "rotate_half": bool(torch.equal(cat, want_cat))}
    # attention where the "model" dim divides neither the rows nor the
    # heads (2 heads, 4 ranks): each rank attends its own queries
    # (sharding.perf.local_attention), K and V's gradients partial sums
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.layers import streaming_attention
    qmesh = init_device_mesh("cpu", (1, WS), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(6)
    qkv = [torch.randn((2, 8, h, 16), generator=g) for h in (2, 1, 1)]
    w = torch.randn((2, 8, 2, 16), generator=g)
    ref = [t.clone().requires_grad_(True) for t in qkv]
    o1 = streaming_attention(*ref, q_offset=0, causal=True, window=None)
    (o1 * w).sum().backward()
    dts = [distribute_tensor(t, qmesh, [Replicate(), Replicate()])
           .requires_grad_(True) for t in qkv]
    o2 = streaming_attention(*dts, q_offset=0, causal=True, window=None)
    (o2.full_tensor() * w).sum().backward()
    out["attention"] = {
        "placements": [str(p) for p in o2.placements],
        "out_rel": rel(o2, o1),
        "grad_rel": max(rel(d.grad, r.grad) for d, r in zip(dts, ref))}
    report(**out)
    """)

RING_SEED = 3


def _ring_body() -> str:
    return textwrap.dedent(f"""
        from repro_torch.optim.compress import _quant_int8, ring_allreduce_int8
        rng = np.random.default_rng({RING_SEED})
        q = rng.integers(-127, 128, (WS, 64)).astype(np.int8)
        s = (rng.random(WS) * 0.1 + 1e-3).astype(np.float32)
        got = ring_allreduce_int8(torch.from_numpy(q[RANK]),
                                  torch.tensor(s[RANK]))
        bits = [None] * WS
        dist.all_gather_object(bits, got.numpy().view(np.uint32).tolist())
        x = rng.normal(size=(WS, 64)).astype(np.float32)
        qx, sx = _quant_int8(torch.from_numpy(x[RANK]))
        ring = ring_allreduce_int8(qx, sx)
        mean = torch.from_numpy(x[RANK]).clone()
        dist.all_reduce(mean)
        mean = mean / WS
        err = float((ring - mean).abs().max() / mean.abs().max())
        errs = [None] * WS
        dist.all_gather_object(errs, err)
        report(bits=bits, rel=max(errs))
        """)


def _ring_reference(n: int) -> list:
    """The reference's ring over ``n`` host devices on the same payloads:
    row r is what rank r returns."""
    code = textwrap.dedent(f"""
        import os, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
        import jax, numpy as np
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from repro.optim.compress import ring_allreduce_int8
        if hasattr(jax, "shard_map"):
            shard_map, check = jax.shard_map, {{"check_vma": False}}
        else:
            from jax.experimental.shard_map import shard_map
            check = {{"check_rep": False}}
        rng = np.random.default_rng({RING_SEED})
        q = rng.integers(-127, 128, ({n}, 64)).astype(np.int8)
        s = (rng.random({n}) * 0.1 + 1e-3).astype(np.float32)
        mesh = jax.make_mesh(({n},), ("data",))

        def ring(q, s):
            return ring_allreduce_int8(q, s[0], "data")

        f = jax.jit(shard_map(ring, mesh=mesh, in_specs=(P("data"), P("data")),
                              out_specs=P("data"), **check))
        out = np.asarray(f(jnp.asarray(q), jnp.asarray(s)))
        print("RESULT " + json.dumps(out.view(np.uint32).tolist()))
        """)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return _result(out.stdout)


SWEEP_BODY = textwrap.dedent("""
    from repro_torch.core import adc as TADC, analog as TA, errors as TE
    from repro_torch.core import mapping as TM
    from repro_torch.sweep import (Axis, ClassifierEvaluator,
                                   FunctionEvaluator, SweepSpec, run_sweep,
                                   sweep_mesh)
    from repro_torch.sweep import dispatch
    mesh = sweep_mesh()
    assert mesh is not None and mesh.mesh_dim_names == ("data",)
    rng = np.random.default_rng(0)
    dims = (16, 32, 8)
    layers = [(torch.tensor(rng.normal(size=(dims[i], dims[i + 1]))
                            .astype(np.float32) * dims[i] ** -0.5),
               torch.zeros(dims[i + 1])) for i in range(2)]
    xca = torch.tensor(rng.normal(size=(64, 16)).astype(np.float32))
    xte = torch.tensor(rng.normal(size=(128, 16)).astype(np.float32))
    yte = torch.tensor(rng.integers(0, 8, 128))
    base = TA.AnalogSpec(
        mapping=TM.MappingConfig(scheme="differential", bits_per_cell=2,
                                 on_off_ratio=1e3),
        adc=TADC.ADCConfig(style="calibrated", bits=8),
        error=TE.state_proportional(0.0), input_accum="digital")
    grids = {
        # 4 points >= 2 trials, 4 % 4 == 0: points split
        "points": SweepSpec(name="p", base=base, trials=2, seed=3, axes=(
            Axis("error.alpha", (0.01, 0.02, 0.05, 0.1)),)),
        # 3 points do not divide 4; 4 trials do: trials split
        "trials": SweepSpec(name="t", base=base, trials=4, seed=5, axes=(
            Axis("error.alpha", (0.02, 0.05, 0.1)),)),
        # neither divides: every rank runs the group
        "neither": SweepSpec(name="n", base=base, trials=3, seed=7, axes=(
            Axis("error.alpha", (0.02, 0.05, 0.1)),)),
    }
    from repro_torch.sweep import evaluate
    calls = []
    inner = evaluate.trial_accuracy

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    evaluate.trial_accuracy = counted
    out = {}
    for name, sweep in grids.items():
        ev = ClassifierEvaluator(layers, xca, xte, yte, device="cpu")
        del calls[:]
        sharded = run_sweep(sweep, ev, mesh=mesh)
        n_local = len(calls)
        serial = run_sweep(sweep, ev, mesh=None)
        probe = FunctionEvaluator(lambda spec, seed: float(seed % 997),
                                  name="probe", takes_key=True)
        rows = [(0.0,)] * len(sweep.expand())
        _, _, axis = dispatch.shard_point_trial_batch(
            rows, list(range(sweep.trials)), mesh)
        out[name] = {
            "equal": [r.values for r in sharded]
                     == [r.values for r in serial],
            "probe_equal": [r.values for r in run_sweep(sweep, probe,
                                                        mesh=mesh)]
                           == [r.values for r in run_sweep(sweep, probe)],
            "axis": axis, "local_calls": n_local,
            "serial_calls": len(calls) - n_local,
            "n_points": len(serial)}
    report(**out)
    """)


ARCHS = ["gemma-2b", "arctic-480b", "zamba2-7b", "rwkv6-3b",
         "whisper-large-v3"]


@pytest.fixture(scope="module")
def jobs():
    order = [
        _Job("arch-rwkv6-3b", _arch_body("rwkv6-3b"), 4, 400),
        _Job("uneven-rwkv6-3b", _arch_body("rwkv6-3b", (1, 3)), 3, 400),
        _Job("uneven-qwen3-14b", _arch_body("qwen3-14b", (1, 3), n_heads=8,
                                            n_kv_heads=2), 3, 400),
        _Job("uneven-zamba2-7b", _arch_body("zamba2-7b", (2, 3), rows=3,
                                            microbatches=1), 6, 400),
        _Job("variants", VARIANTS_BODY, 4, 400),
        _Job("arch-whisper-large-v3", _arch_body("whisper-large-v3"), 4, 400),
        _Job("arch-zamba2-7b", _arch_body("zamba2-7b"), 4, 400),
        _Job("arch-arctic-480b", _arch_body("arctic-480b"), 4, 400),
        _Job("arch-gemma-2b", _arch_body("gemma-2b"), 4, 400),
        _Job("train", TRAIN_BODY, 4, 400),
        _Job("sweep", SWEEP_BODY, 4, 300),
        _Job("rope", ROPE_BODY, 4, 200),
        _Job("ring-3", _ring_body(), 3, 200),
        _Job("ring-4", _ring_body(), 4, 200),
    ]
    runner = Runner(order, MAX_RANKS)
    yield runner
    # every job ends by its wall limit: wait, so no rank outlives the module
    runner.wait()


def test_sharded_train_step_matches_single_device(jobs):
    r = jobs["train"]
    print("loss rel", r["loss_rel"], "grad norm rel", r["gnorm_rel"],
          "worst parameter", r["param_worst"])
    assert r["loss_rel"] <= REL and r["gnorm_rel"] <= REL, r
    assert r["param_worst"] < PARAM_ATOL, r
    assert r["lr_equal"] and r["placed"], r


@pytest.mark.parametrize("arch", ARCHS)
def test_build_step_all_kinds_match_unsharded(jobs, arch):
    r = jobs[f"arch-{arch}"]
    print(arch, json.dumps(r))
    t = r["train"]
    assert t["loss_rel"] <= REL and t["gnorm_rel"] <= REL, t
    assert t["param_worst"] < PARAM_ATOL and t["lr_equal"], t
    for kind in ("prefill", "decode"):
        k = r[kind]
        assert k["logits_rel"] <= REL and k["cache_rel"] <= REL, (kind, k)
        assert k["tokens_equal"], (kind, k)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen3-14b", "zamba2-7b"])
def test_uneven_heads_match_unsharded(jobs, arch):
    """A (1, 3) mesh, whose ``model`` dim divides neither the 4 heads nor
    shards the rows: rwkv's ``local_recurrence`` runs each rank's 2 heads
    of the padded 6 (``torch.chunk``'s uneven split, the last rank's
    heads all padding) and gathers them whole; qwen3-14b's decode
    attention, its smoke config at 8 q heads over 2 KV heads and a cache
    of 32 positions the mesh cannot split, does the same in
    ``local_attention`` (3 heads a rank: the middle rank's span both KV
    heads, each q head given its own, the others' share one).  zamba2's
    4 MHA heads and 4 Mamba2 heads on a (2, 3) mesh at 3 rows (trained
    in one microbatch), which ``data`` does not divide: ``data`` splits
    the heads evenly (2 a rank, each ``data`` rank its own KV block),
    then ``model`` pads them (1 a rank, its last rank's all padding, in
    the attention and in the recurrence).  Train, prefill and decode
    against the unsharded step as ``build_step``'s other cases."""
    r = jobs[f"uneven-{arch}"]
    print(json.dumps(r))
    t = r["train"]
    assert t["loss_rel"] <= REL and t["gnorm_rel"] <= REL, t
    assert t["param_worst"] < PARAM_ATOL and t["lr_equal"], t
    for kind in ("prefill", "decode"):
        k = r[kind]
        assert k["logits_rel"] <= REL and k["cache_rel"] <= REL, (kind, k)
        assert k["tokens_equal"], (kind, k)


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen3-moe-235b-a22b",
                                  "arctic-480b"])
def test_every_variant_equals_baseline(jobs, arch):
    from repro_torch.sharding.perf import VARIANTS

    r = jobs["variants"][arch]
    print(arch, r)
    assert sorted(r) == sorted(VARIANTS)
    bad = {k: v for k, v in r.items() if not v <= REL}
    assert not bad, bad


def test_rope_rotate_half_on_a_model_sharded_q_is_exact(jobs):
    r = jobs["rope"]
    assert all(r[k]["rope"] and r[k]["rotate_half"]
               for k in ("heads", "within_heads", "seq")), r


def test_attention_split_by_queries_matches_unsharded(jobs):
    """A (1, 4) mesh whose ``model`` dim divides neither the batch nor
    the 2 heads: ``local_attention`` splits the queries over it, and the
    output and the gradients of q, k and v equal the unsharded
    attention's within ``REL`` (K and V's gradients are partial sums
    over the ranks' queries)."""
    r = jobs["rope"]["attention"]
    print(r)
    assert r["placements"][1] == "S(1)", r      # "model": the queries
    assert r["out_rel"] <= REL and r["grad_rel"] <= REL, r


@pytest.mark.parametrize("n", [3, 4])
def test_int8_ring_equals_the_reference_ring(jobs, n):
    want = _ring_reference(n)
    r = jobs[f"ring-{n}"]
    # row r is rank r's answer: each rank sums in its own arrival order
    assert r["bits"] == want
    print("ring vs all_reduce mean, rel", r["rel"])
    assert r["rel"] < RING_REL, r["rel"]


def test_sweep_grid_on_a_mesh_equals_serial(jobs):
    r = jobs["sweep"]
    print(json.dumps(r))
    assert [r[g]["axis"] for g in ("points", "trials", "neither")] \
        == [0, 1, None]
    for g, v in r.items():
        assert v["equal"] and v["probe_equal"], (g, v)
    # each rank drew only its share of (point, trial) seeds
    p, t, n = r["points"], r["trials"], r["neither"]
    assert p["local_calls"] * 4 == p["serial_calls"], p
    assert t["local_calls"] * 4 == t["serial_calls"], t
    assert n["local_calls"] == n["serial_calls"], n
    assert (p["n_points"], t["n_points"], n["n_points"]) == (4, 3, 3)
