"""The port's training substrate against the JAX reference: ``config``'s
``ShapeConfig``/``SHAPES``, ``data.synthetic``, ``optim.adamw``,
``optim.compress`` and ``checkpoint.manager`` (``tests/test_substrate.py``'s
cases carried over, plus cross-framework holds).

* Data: a batch is a pure function of (seed, step); the port's streams
  cannot equal ``jax.random``'s, so both packages' streams are held by
  their statistics, each within 5 sigma of the stream's formula: the
  affine process's strides ``31 + 2 * {0..7}`` at 1/8 each, the noise
  fraction ``noise * (1 - 1/vocab)``, uniform starts and tokens, and the
  prefix embeddings' ``N(0, 0.02^2)``.  (A CUDA-requested dataset's bits
  equal a CPU one's: ``tests/test_torch_cuda.py``.)
* AdamW: the reference's numpy check; against the reference's own
  ``update`` on the same gradients over six steps, parameters and moments
  within 2 ulp of the operands' scale (the port's arithmetic is the
  eager reference's; XLA's compiled form contracts and moves a few
  elements); ``1 - b ** t`` within an ulp of ``b ** t`` and one of the
  result (torch's and XLA's float32 ``pow`` differ by an ulp at some t); the schedule's
  warm-up equal to the bit and its cosine within 2 ulp; the clipped norm
  within 2 ulp (``jnp.sum`` and ``torch.sum`` reduce in different
  orders), in sorted leaf order.
* Error feedback: the reference's cumulative bound, and int8 codes, scales
  and residuals equal to the reference's.  ``softmax_xent`` within 4 ulp
  of the reference's loss.
* Checkpoints: the reference's round trip, GC, async save and elastic
  placement hook; and a ``TrainState`` written by either package restored
  by the other equal to the bit, with identical file names, manifests and
  ``.npy`` bytes.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.config import SHAPES as J_SHAPES
from repro.config import ModelConfig as JModelConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.configs import get_smoke_config as j_smoke
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro.train import step as JS
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.data.synthetic import SyntheticLM, for_shape
from repro_torch.optim import adamw
from repro_torch.optim import compress
from repro_torch.pytree import flatten_with_path
from repro_torch.train import step as TS


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_np(tree) -> dict:
    """name -> numpy array of a tree of either package."""
    return {n: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for n, v in flatten_with_path(tree)}


def _ulps(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float((np.abs(np.asarray(got) - want)
                  / np.spacing(np.abs(want))).max())


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_shape_configs_equal_the_reference():
    assert [f.name for f in dataclasses.fields(ShapeConfig)] \
        == [f.name for f in dataclasses.fields(JShapeConfig)]
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(J_SHAPES[name])
    cfg = t_smoke("qwen1.5-4b")
    ds = for_shape(cfg, SHAPES["train_4k"], seed=2, device="cpu")
    assert (ds.seq_len, ds.global_batch, ds.seed, ds.mode) \
        == (4096, 256, 2, "lm")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_data_deterministic_and_step_addressable():
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=8,
                      n_heads=1, n_kv_heads=1, d_ff=8, vocab=101)
    ds = SyntheticLM(cfg=cfg, seq_len=16, global_batch=4, seed=3,
                     device="cpu")
    b1 = ds.batch(7)
    b2 = ds.batch(7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].dtype == torch.int32
    b3 = ds.batch(8)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert torch.equal(b1["targets"][:, :-1], b1["tokens"][:, 1:])
    assert ds.state(7) == {"seed": 3, "step": 7, "mode": "lm"}
    # a fresh dataset (a restarted run) replays the step's batch
    again = SyntheticLM(cfg=cfg, seq_len=16, global_batch=4, seed=3,
                        device="cpu")
    assert torch.equal(again.batch(torch.tensor(7))["tokens"], b1["tokens"])
    other = SyntheticLM(cfg=cfg, seq_len=16, global_batch=4, seed=4,
                        device="cpu")
    assert not torch.equal(other.batch(7)["tokens"], b1["tokens"])


V, B, S = 1009, 2048, 64


def _lm_stats(tokens: np.ndarray, v: int):
    """Per row the modal stride and the share of positions off the affine
    line it implies (anchored where three consecutive tokens agree)."""
    tokens = tokens.astype(np.int64)
    strides, off = [], []
    for row in tokens:
        d = (row[1:] - row[:-1]) % v
        m = np.bincount(d, minlength=v).argmax()
        i = int(np.flatnonzero((d[:-1] == m) & (d[1:] == m))[0])
        start = (row[i] - m * i) % v
        line = (start + m * np.arange(len(row))) % v
        strides.append(m)
        off.append(row != line)
    return np.array(strides), np.concatenate(off)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_lm_stream_statistics(pkg):
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=8,
                      n_heads=1, n_kv_heads=1, d_ff=8, vocab=V)
    if pkg == "reference":
        jcfg = JModelConfig(**dataclasses.asdict(cfg))
        tok = np.asarray(JSyntheticLM(jcfg, S, B, seed=5).batch(11)["tokens"])
    else:
        tok = SyntheticLM(cfg, S, B, seed=5, device="cpu") \
            .batch(11)["tokens"].numpy()
    assert tok.shape == (B, S) and tok.dtype == np.int32
    strides, off = _lm_stats(tok, V)
    assert set(strides.tolist()) == set(range(31, 46, 2))
    counts = np.bincount(strides, minlength=46)[31::2]
    sd = np.sqrt(B * (1 / 8) * (7 / 8))
    assert np.all(np.abs(counts - B / 8) < 5 * sd), counts
    p = 0.1 * (1 - 1 / V)
    assert abs(off.mean() - p) < 5 * np.sqrt(p * (1 - p) / off.size), \
        off.mean()
    starts = tok[:, 0].astype(np.float64)      # noise or start: uniform
    assert abs(starts.mean() - (V - 1) / 2) \
        < 5 * np.sqrt((V * V - 1) / 12 / B)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_uniform_stream_and_prefix_statistics(pkg):
    cfg = ModelConfig(name="t", family="vlm", n_layers=1, d_model=32,
                      n_heads=1, n_kv_heads=1, d_ff=8, vocab=V,
                      frontend="vision_patches", n_frontend_tokens=8)
    if pkg == "reference":
        jcfg = JModelConfig(**dataclasses.asdict(cfg))
        b = _np_tree(JSyntheticLM(jcfg, S, 256, seed=5,
                                  mode="uniform").batch(3))
    else:
        b = {k: v.numpy() for k, v in SyntheticLM(
            cfg, S, 256, seed=5, mode="uniform", device="cpu")
            .batch(3).items()}
    tok = b["tokens"]
    n = tok.size
    hist = np.bincount(tok.reshape(-1), minlength=V)
    assert hist.size == V
    chi2 = ((hist - n / V) ** 2 / (n / V)).sum()
    assert abs(chi2 - (V - 1)) < 5 * np.sqrt(2 * (V - 1)), chi2
    pe = b["prefix_embeds"]
    assert pe.shape == (256, 8, 32) and pe.dtype == np.float32
    assert abs(pe.mean()) < 5 * 0.02 / np.sqrt(pe.size)
    assert abs(pe.std() / 0.02 - 1) < 5 / np.sqrt(2 * pe.size)


def test_prefix_embeds_have_their_own_stream():
    cfg = t_smoke("internvl2-26b")
    ds = SyntheticLM(cfg, 16, 2, seed=0, device="cpu")
    b = ds.batch(4)
    assert b["prefix_embeds"].shape == (2, cfg.n_frontend_tokens,
                                        cfg.d_model)
    # the prefix draw does not move the token stream
    plain = SyntheticLM(dataclasses.replace(cfg, frontend=None), 16, 2,
                        seed=0, device="cpu")
    assert torch.equal(plain.batch(4)["tokens"], b["tokens"])
    assert torch.equal(ds.batch(4)["prefix_embeds"], b["prefix_embeds"])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_adamw_matches_numpy_reference():
    rng = np.random.RandomState(0)
    p = {"w": torch.as_tensor(rng.randn(5, 3), dtype=torch.float32)}
    g = {"w": torch.as_tensor(rng.randn(5, 3), dtype=torch.float32)}
    st = adamw.init(p)
    lr, b1, b2, eps, wd = 1e-2, 0.9, 0.95, 1e-8, 0.1
    new_p, st = adamw.update(g, st, p, lr=lr, b1=b1, b2=b2, eps=eps,
                             weight_decay=wd)
    assert st.step.dtype == torch.int32 and int(st.step) == 1
    m = (1 - b1) * g["w"].numpy()
    v = (1 - b2) * g["w"].numpy() ** 2
    mh = m / (1 - b1)
    vh = v / (1 - b2)
    upd = mh / (np.sqrt(vh) + eps) + wd * p["w"].numpy()
    ref = p["w"].numpy() - lr * upd
    np.testing.assert_allclose(new_p["w"].numpy(), ref, rtol=1e-5)


def test_adamw_update_equals_the_reference_within_ulps():
    rng = np.random.default_rng(0)
    shapes = {"w": (257, 129), "b": {"z": (17,), "a": (5, 3)}}
    make = lambda f: jax.tree.map(  # noqa: E731
        f, shapes, is_leaf=lambda x: isinstance(x, tuple))
    p = make(lambda s: rng.standard_normal(s).astype(np.float32))
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.as_tensor, p)
    js, ts = JA.init(jp), adamw.init(tp)
    upd_jit = jax.jit(lambda g, s, p, lr: JA.update(g, s, p, lr=lr))
    for _ in range(6):
        g = make(lambda s: (rng.standard_normal(s) * 10.0 ** rng.integers(
            -12, 1, s)).astype(np.float32))
        jg = jax.tree.map(jnp.asarray, g)
        eager = JA.update(jg, js, jp, lr=3e-4)
        compiled = upd_jit(jg, js, jp, 3e-4)
        tp, ts = adamw.update(jax.tree.map(torch.as_tensor, g), ts, tp,
                              lr=3e-4)
        gf = _flat_np(g)
        old = {"p": _flat_np(jp), "mu": _flat_np(js.mu),
               "nu": _flat_np(js.nu)}
        # an ulp of the operands' scale: a result that cancels (p near
        # lr * u, a moment near its decayed self) is held to its inputs'
        terms = {"p": {n: 0 * v for n, v in gf.items()},
                 "mu": {n: 0.1 * np.abs(v) for n, v in gf.items()},
                 "nu": {n: 0.05 * v * v for n, v in gf.items()}}
        for ref_p, ref_s in (eager, compiled):
            for part, got, want in (("p", tp, ref_p), ("mu", ts.mu, ref_s.mu),
                                    ("nu", ts.nu, ref_s.nu)):
                gw, ww = _flat_np(got), _flat_np(want)
                assert gw.keys() == ww.keys()
                for n in gw:
                    scale = np.maximum.reduce([np.abs(ww[n]),
                                               np.abs(old[part][n]),
                                               terms[part][n]])
                    err = np.abs(gw[n] - ww[n])
                    assert (err <= 2 * np.spacing(scale.astype(np.float32))
                            ).all(), (part, n)
        jp, js = eager
    assert int(ts.step) == int(js.step) == 6


def test_bias_correction_pow_within_an_ulp_of_the_reference():
    """``1 - b ** t``: torch's float32 ``pow`` and XLA's differ by an ulp
    at a few t (e.g. t = 31 for b1 = 0.9), so the bias corrections are
    held within one ulp of ``b ** t`` plus the subtraction's rounding, not
    to the bit."""
    t = np.arange(1, 2000, dtype=np.float32)
    for b in (0.9, 0.95, 0.999):
        bt = np.asarray(b ** jnp.asarray(t))
        normal = bt >= np.finfo(np.float32).tiny
        want = np.asarray(1.0 - b ** jnp.asarray(t))
        got = (1.0 - torch.pow(b, torch.as_tensor(t))).numpy()
        err = np.abs(got - want)[normal]
        assert (err <= np.spacing(bt[normal])
                + np.spacing(want[normal])).all(), b


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0), "b": torch.full((5,), -4.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(adamw.global_norm(clipped)) <= 1.0 + 1e-5
    assert float(norm) > 1.0
    small, n2 = adamw.clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(small["a"], torch.full((4,), 0.1))
    assert float(n2) == pytest.approx(0.2)


def test_global_norm_sums_in_sorted_leaf_order_like_the_reference():
    rng = np.random.default_rng(3)
    # keys inserted out of order: the sum must follow jax.tree.leaves
    tree = {"z": rng.standard_normal(4096).astype(np.float32) * 1e3,
            "a": {"y": rng.standard_normal(7).astype(np.float32),
                  "b": rng.standard_normal((64, 3)).astype(np.float32)},
            "m": rng.standard_normal(999).astype(np.float32) * 1e-3}
    t = jax.tree.map(torch.as_tensor, tree)
    assert [n for n, _ in flatten_with_path(t)] == ["a/b", "a/y", "m", "z"]
    got = float(adamw.global_norm(t))
    want = float(JA.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert _ulps(got, want) <= 2
    for max_norm in (1.0, 1e6):
        jc, jn = JA.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                        max_norm)
        tc, tn = adamw.clip_by_global_norm(t, max_norm)
        assert _ulps(float(tn), float(jn)) <= 2
        for n, v in _flat_np(tc).items():
            assert _ulps(v, _flat_np(jc)[n]) <= 3, n


def test_cosine_schedule():
    lr = adamw.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1e-3) < 1e-9
    assert float(lr(100)) < 1e-5
    assert float(lr(5)) == pytest.approx(5e-4)


@pytest.mark.parametrize("base,warmup,total", [(1e-3, 10, 100),
                                               (3e-4, 2, 8), (3e-3, 0, 1)])
def test_cosine_schedule_equals_the_reference(base, warmup, total):
    """Warm-up equal to the bit (both divide); the cosine part within 2 ulp
    (torch's and XLA's float32 ``cos`` differ by an ulp at some steps)."""
    j = JA.cosine_schedule(base, warmup, total)
    t = adamw.cosine_schedule(base, warmup, total)
    for s in range(total + 3):
        want = np.float32(j(s))
        for got in (t(torch.tensor(s, dtype=torch.int32)), t(s)):
            got = np.float32(got)
            if s < warmup:
                assert got == want, s
            else:
                assert abs(got - want) <= 2 * np.spacing(np.float32(base)), s


def test_ef_compression_residual_bounds_error():
    rng = np.random.RandomState(1)
    g = {"w": torch.as_tensor(rng.randn(64), dtype=torch.float32)}
    res = compress.init_residual(g)
    total_true = np.zeros(64)
    total_sent = np.zeros(64)
    for _ in range(20):
        gi = {"w": torch.as_tensor(rng.randn(64), dtype=torch.float32)}
        total_true += gi["w"].numpy()
        q, s, res = compress.ef_compress(gi, res)
        assert q["w"].dtype == torch.int8
        total_sent += q["w"].numpy().astype(np.float32) * s["w"].numpy()
    err = np.abs(total_true - total_sent).max()
    assert err < 0.2, err


def test_ef_compression_equals_the_reference():
    rng = np.random.default_rng(2)
    g = {"w": rng.standard_normal((33, 7)).astype(np.float32),
         "b": {"c": (rng.standard_normal(5) * 1e-14).astype(np.float32)}}
    jres = JC.init_residual(jax.tree.map(jnp.asarray, g))
    tres = compress.init_residual(jax.tree.map(torch.as_tensor, g))
    for _ in range(4):
        jq, js, jres = JC.ef_compress(jax.tree.map(jnp.asarray, g), jres)
        tq, ts, tres = compress.ef_compress(
            jax.tree.map(torch.as_tensor, g), tres)
        for got, want in ((tq, jq), (ts, js), (tres, jres)):
            gw, ww = _flat_np(got), _flat_np(want)
            for n in gw:
                assert np.array_equal(gw[n], ww[n]), n
        g = jax.tree.map(lambda x: x * np.float32(1.5), g)


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_softmax_xent_within_float32_bound_of_the_reference(scale):
    """The logsumexp is held within 4 float32 ulp of the loss, not to the
    bit (XLA and PyTorch reduce in different orders)."""
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((4, 16, 1000)) * scale).astype(np.float32)
    targets = rng.integers(0, 1000, (4, 16)).astype(np.int32)
    want = float(JS.softmax_xent(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(TS.softmax_xent(torch.as_tensor(logits),
                                torch.as_tensor(targets)))
    assert abs(got - want) <= 4 * np.spacing(np.float32(want)), (got, want)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for step in (1, 2, 3):
        mgr.save(step, {"a": tree["a"] * step, "b": {"c": tree["b"]["c"]
                                                      * step}},
                 extra={"step": step})
    assert mgr.all_steps() == [2, 3]  # gc kept last 2
    out, step, extra = mgr.restore(tree, device="cpu")
    assert step == 3 and extra == {"step": 3}
    assert torch.equal(out["a"], torch.arange(6).reshape(2, 3) * 3)
    assert torch.equal(out["b"]["c"], torch.full((4,), 3.0))
    out, step, _ = mgr.restore(tree, step=2, device="cpu")
    assert step == 2 and torch.equal(out["b"]["c"], torch.full((4,), 2.0))
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_checkpoint_restore_without_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore({"w": torch.ones(2)}, device="cpu")


def test_checkpoint_async_and_elastic_placement_hook(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = torch.ones((8, 4))
    mgr.save_async(5, {"w": w, "s": torch.zeros((), dtype=torch.int32)})
    w.add_(1.0)     # the host copy was taken at the call
    mgr.wait()
    calls = []

    def placement_fn(name, shape):
        calls.append((name, shape))
        return "cpu" if name == "w" else None

    out, step, _ = mgr.restore({"w": w, "s": 0}, placement_fn=placement_fn,
                               device="cpu")
    assert step == 5
    assert calls == [("s", ()), ("w", (8, 4))]
    assert torch.equal(out["w"], torch.ones((8, 4)))
    assert out["s"].dtype == torch.int32


def _dir_files(path) -> dict:
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def test_checkpoint_round_trip_between_packages_is_bit_exact(tmp_path):
    arch = "qwen1.5-4b"
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jstate = JS.make_train_state(jcfg, jax.random.PRNGKey(0))
    batch = _np_tree(JSyntheticLM(jcfg, 8, 2, seed=0).batch(0))
    jstate, _ = jax.jit(JS.train_step_fn(jcfg, lr=1e-2))(jstate, batch)
    extra = {"data": {"seed": 0, "step": 1, "mode": "lm"}}

    # reference writes, the port restores
    JCkpt(str(tmp_path / "ref")).save(1, jstate, extra=extra)
    template = TS.make_train_state(tcfg, 1, device="cpu")
    tstate, step, got_extra = CheckpointManager(str(tmp_path / "ref")) \
        .restore(template, device="cpu")
    assert step == 1 and got_extra == extra
    assert isinstance(tstate, TS.TrainState)
    want = _flat_np(jstate)
    got = _flat_np(tstate)
    assert list(got) == list(want)
    assert "params/layers/attn/wq" in got and "opt/mu/embed" in got \
        and "opt/step" in got and "step" in got
    for n in want:
        assert got[n].dtype == want[n].dtype and np.array_equal(got[n],
                                                                want[n]), n

    # the port writes, the reference restores
    CheckpointManager(str(tmp_path / "port")).save(1, tstate, extra=extra)
    ref_dir = tmp_path / "ref" / "step_000000001"
    port_dir = tmp_path / "port" / "step_000000001"
    assert _dir_files(ref_dir) == _dir_files(port_dir)
    with open(port_dir / "manifest.json") as f:
        manifest = json.load(f)
    assert all(m["shard"] is None for m in manifest["leaves"].values())
    back, step, _ = JCkpt(str(tmp_path / "port")).restore(jstate)
    assert step == 1
    for n, v in _flat_np(back).items():
        assert np.array_equal(v, want[n]), n
