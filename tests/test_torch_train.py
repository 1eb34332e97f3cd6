"""The port's training step (``repro_torch.train.step``) against the JAX
reference, each case starting from the reference's parameters and batch
(exported to numpy), the reference's step compiled once per (config,
microbatches).

* One step, for every ``ARCH_IDS`` smoke config at microbatches 1 and 2
  (frontend families with the reference's ``prefix_embeds`` draw, MoE
  configs with ``MOE_LB_COEF * mean(lb_loss)``): loss and grad norm
  within 5e-6 relative, lr equal; moments within 3e-5 (``mu``) and 6e-5
  (``nu``) of each leaf's largest magnitude (the gradient's float32
  rounding across frameworks); parameters within 4 ulp + ``lr`` x (1e-5 +
  du), du the change in AdamW's first-step direction ``g / (|g| + eps)``
  that a gradient error of 3e-5 of the leaf's largest ``|g|`` can make
  at that element (capped at 2, a sign flip where ``|g|`` is rounding
  noise; exact zeros, e.g. unseen tokens' embedding rows, keep du 0); at
  most 0.5% of a config's elements may take the cap.
* ``tests/test_arch_smoke.py``'s two-step test, on the port.
* Remat: gradients with per-layer checkpoints equal those without
  (``torch.equal``) for the dense, MoE, rwkv, hybrid and encdec families.
* The trained-LM recipe of ``benchmarks/lm_accuracy.py`` (``trained_lm``:
  120 steps at lr 3e-3, batch 8 x 32, ``qwen1.5-4b``'s smoke config) run
  in both packages from the reference's init on the reference's batches:
  the final eval loss on the ``EVAL_STEP`` batch within 2e-5 (measured
  1.2e-6 apart), and so is the last step's loss.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from benchmarks.lm_accuracy import (ARCH, BATCH, EVAL_STEP, SEED, SEQ_LEN,
                                    TRAIN_STEPS)
from repro.configs import get_smoke_config as j_smoke
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.train import step as JS
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models.registry import get_model
from repro_torch.pytree import flatten_with_path
from repro_torch.train import step as TS

LR = 1e-2
B, S = 4, 16
LOSS_RTOL = 5e-6
MU_REL, NU_REL = 3e-5, 6e-5
GRAD_REL = 3e-5      # gradient error, of the leaf's largest |g|
EPS = 1e-8           # AdamW's eps
RECIPE_ATOL = 2e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    return {n: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for n, v in flatten_with_path(tree)}


def _torch_batch(batch) -> dict:
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference():
    """Per arch, the reference's initial state and batch (drawn once for
    both microbatch counts), and its train step per (arch, microbatches),
    compiled once."""
    @functools.lru_cache(maxsize=None)
    def inputs(arch):
        jcfg = j_smoke(arch)
        return (JS.make_train_state(jcfg, jax.random.PRNGKey(0)),
                _np_tree(JSyntheticLM(jcfg, S, B, seed=1).batch(3)))

    @functools.lru_cache(maxsize=None)
    def step(arch, microbatches):
        return jax.jit(JS.train_step_fn(j_smoke(arch),
                                        microbatches=microbatches, lr=LR))
    return inputs, step


def _adamw_param_bound(p_old, p_ref, mu_ref, lr):
    """Per-element bound on |p_port - p_ref| after AdamW's first step."""
    g = mu_ref / np.float32(0.1)                 # mu = (1 - b1) g at step 1
    ag = np.abs(g)
    dg = GRAD_REL * ag.max()
    denom = np.maximum(ag - dg, 0) + EPS
    du = np.where(g == 0, 0.0, np.minimum(2.0, dg * EPS / denom ** 2))
    ulp = np.spacing(np.maximum(np.abs(p_old), np.abs(p_ref))
                     .astype(np.float32))
    return 4 * ulp + lr * (1e-5 + du), du >= 2.0


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_step_matches_the_reference(reference, arch, microbatches):
    inputs, ref_step = reference
    tcfg = t_smoke(arch)
    jstate, batch = inputs(arch)
    assert ("prefix_embeds" in batch) == bool(tcfg.frontend)
    jnew, jm = ref_step(arch, microbatches)(jstate, batch)

    state = TS.train_state_from_numpy(_np_tree(jstate.params), device="cpu")
    new, m = TS.train_step_fn(tcfg, microbatches=microbatches, lr=LR)(
        state, _torch_batch(batch))

    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert np.float32(m["lr"]) == np.float32(jm["lr"])
    assert int(new.step) == int(new.opt.step) == 1
    assert int(jnew.step) == int(jnew.opt.step) == 1

    p0 = _flat(jstate.params)
    want = {"p": _flat(jnew.params), "mu": _flat(jnew.opt.mu),
            "nu": _flat(jnew.opt.nu)}
    got = {"p": _flat(new.params), "mu": _flat(new.opt.mu),
           "nu": _flat(new.opt.nu)}
    for part in got:
        assert got[part].keys() == want[part].keys(), part
    capped = total = 0
    for n in want["p"]:
        for part, rel in (("mu", MU_REL), ("nu", NU_REL)):
            w = want[part][n]
            assert got[part][n].dtype == np.float32
            assert np.abs(got[part][n] - w).max() <= rel * np.abs(w).max(), \
                (part, n)
        bound, cap = _adamw_param_bound(p0[n], want["p"][n], want["mu"][n],
                                        LR)
        err = np.abs(got["p"][n] - want["p"][n])
        assert (err <= bound).all(), (n, float((err / bound).max()))
        capped += int(cap.sum())
        total += cap.size
    assert capped <= 0.005 * total, (capped, total)


def _inputs(cfg, rng):
    tokens = rng.integers(0, cfg.vocab, (2, S))
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32),
             "targets": torch.as_tensor(np.roll(tokens, -1, axis=1),
                                        dtype=torch.int32)}
    if cfg.frontend:
        batch["prefix_embeds"] = torch.as_tensor(
            rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model))
            * 0.02, dtype=torch.float32)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_decreases_loss_and_is_finite(arch):
    cfg = t_smoke(arch)
    state = TS.make_train_state(cfg, 0, device="cpu")
    batch = _inputs(cfg, np.random.default_rng(1))
    step = TS.train_step_fn(cfg, microbatches=1, lr=1e-2)
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) < float(m1["loss"]) + 1e-3


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen3-moe-235b-a22b",
                                  "rwkv6-3b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_remat_gradients_equal_plain(arch):
    cfg = t_smoke(arch)
    params = get_model(cfg).init_params(cfg, 0, device="cpu")
    batch = _inputs(cfg, np.random.default_rng(2))
    l0, _, g0 = TS.loss_and_grads(dataclasses.replace(cfg, remat=False),
                                  params, batch)
    l1, _, g1 = TS.loss_and_grads(dataclasses.replace(cfg, remat=True),
                                  params, batch)
    assert torch.equal(l0, l1)
    f0, f1 = dict(flatten_with_path(g0)), dict(flatten_with_path(g1))
    assert f0.keys() == f1.keys()
    for n in f0:
        assert torch.equal(f0[n], f1[n]), n


def test_remat_checkpoints_each_layer(monkeypatch):
    """Under remat the layers run through ``torch.utils.checkpoint`` (one
    call a layer) only while a gradient is recorded."""
    from repro_torch.models import layers

    calls = []
    real = layers.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(layers, "checkpoint", counting)
    cfg = t_smoke("qwen1.5-4b")
    params = get_model(cfg).init_params(cfg, 0, device="cpu")
    batch = _inputs(cfg, np.random.default_rng(3))
    TS.loss_and_grads(dataclasses.replace(cfg, remat=True), params, batch)
    assert calls == [False] * cfg.n_layers
    with torch.no_grad():
        get_model(cfg).forward(cfg, params, batch["tokens"], remat=True)
    TS.loss_and_grads(cfg, params, batch)      # the smoke config's remat
    assert not cfg.remat and len(calls) == cfg.n_layers


def test_trained_lm_recipe_matches_the_reference():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    ds = JSyntheticLM(cfg=jcfg, seq_len=SEQ_LEN, global_batch=BATCH,
                      seed=SEED)
    jstate = JS.make_train_state(jcfg, jax.random.PRNGKey(SEED), lr=3e-3)
    state = TS.train_state_from_numpy(_np_tree(jstate.params), device="cpu")
    jstep = jax.jit(JS.train_step_fn(jcfg, microbatches=1, lr=3e-3))
    step = TS.train_step_fn(tcfg, microbatches=1, lr=3e-3)
    for i in range(TRAIN_STEPS):
        batch = _np_tree(ds.batch(i))
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _torch_batch(batch))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= RECIPE_ATOL
    ev = _np_tree(ds.batch(EVAL_STEP))
    want = float(JS.loss_fn(jcfg, jstate.params, ev)[0])
    got = float(TS.loss_fn(tcfg, state.params, _torch_batch(ev))[0])
    assert want < 3.5       # trained: the initial loss is ~5.3
    assert abs(got - want) <= RECIPE_ATOL, (got, want)
