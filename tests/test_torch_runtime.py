"""The port's continuous-batching runtime (``repro_torch.serve.runtime``).

Its serving contract is the reference's: scheduling never changes what
the model says — variable-length prompts drained through the slot
scheduler equal per-request ``decode_lm`` token for token, digital and
through an analog pack.  The flash backend's plain version may round
differently from the streaming attention, so it is held to the near-tie
rule: identical tokens, except where the top-2 logit gap at the first
diverging step is under 1e-4 of the logit scale.  Also: the package and
every submodule import without ``jax`` or ``repro``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import analog as A
from repro_torch.core import errors as E
from repro_torch.models import transformer as T
from repro_torch.serve import (SamplerConfig, ServeRuntime, calibrate_lm,
                               decode_lm, program_lm)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
NPZ = os.path.join(ROOT, "benchmarks", "_cache", "lm_qwen1_5-4b_0.npz")


@pytest.fixture(scope="module")
def lm():
    cfg = get_smoke_config("qwen1.5-4b")
    params = interop.load_params_npz(NPZ, device="cpu")
    calib = np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 16))
    spec = A.design_a(error=E.state_independent(0.05), fused="kernel")
    pack = calibrate_lm(cfg, params, program_lm(cfg, params, spec, seed=5),
                        torch.as_tensor(calib))
    return cfg, params, pack


def _trace(cfg, n, seed=0, lens=(3, 15), new=(2, 9)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, size=int(rng.integers(*lens)))
             .astype(np.int32), int(rng.integers(*new)))
            for _ in range(n)]


def _serve(cfg, params, reqs, **kw):
    rt = ServeRuntime(cfg, params, **kw)
    uids = [rt.submit(p, max_new_tokens=n) for p, n in reqs]
    outs = rt.run()
    return [outs[u] for u in uids]


@pytest.mark.parametrize("analog", [False, True], ids=["digital", "analog"])
def test_runtime_matches_decode_lm(lm, analog):
    cfg, params, pack = lm
    pack = pack if analog else None
    reqs = _trace(cfg, 7, seed=1, lens=(3, 12), new=(2, 7))
    outs = _serve(cfg, params, reqs, pack=pack, max_slots=3, max_len=24)
    agree = total = 0
    for (p, n), got in zip(reqs, outs):
        ref = decode_lm(cfg, params, torch.as_tensor(p)[None], n,
                        pack=pack)[0].numpy()
        assert got.shape == (n,)
        agree += int((got == ref).sum())
        total += n
    assert agree / total == 1.0


def _near_tie(cfg, params, pack, prompt, ref, got, rel=1e-4):
    diff = np.nonzero(ref != got)[0]
    if diff.size == 0:
        return True
    seq = torch.as_tensor(np.concatenate([prompt, ref[:diff[0]]]))[None]
    lg = T.forward(cfg, params, seq, pack=pack)[0][0, -1]
    top2 = torch.topk(lg, 2).values
    return float(top2[0] - top2[1]) < rel * float(lg.abs().max())


def test_flash_oracle_agrees_with_stream(lm):
    cfg, params, pack = lm
    reqs = _trace(cfg, 5, seed=2, lens=(3, 12), new=(3, 7))
    kw = dict(pack=pack, max_slots=2, max_len=24)
    stream = _serve(cfg, params, reqs, attn_backend="stream", **kw)
    flash = _serve(cfg, params, reqs, attn_backend="flash_oracle", **kw)
    for (p, _), s_out, f_out in zip(reqs, stream, flash):
        assert _near_tie(cfg, params, pack, p, s_out, f_out)


def test_flash_backend_on_cpu_runs_the_plain_version(lm):
    """attn_backend="flash" on CPU tensors takes the kernel's plain version
    (the CUDA kernel runs only on the card) and serves identically to
    "flash_oracle"."""
    cfg, params, pack = lm
    reqs = _trace(cfg, 3, seed=3, lens=(3, 9), new=(2, 5))
    kw = dict(pack=pack, max_slots=2, max_len=16)
    a = _serve(cfg, params, reqs, attn_backend="flash", **kw)
    b = _serve(cfg, params, reqs, attn_backend="flash_oracle", **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_gang_mode_serves_identically(lm):
    cfg, params, _ = lm
    reqs = _trace(cfg, 5, seed=4, lens=(3, 10), new=(2, 6))
    a = _serve(cfg, params, reqs, max_slots=3, max_len=24, gang=False)
    b = _serve(cfg, params, reqs, max_slots=3, max_len=24, gang=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_sampled_streams_follow_the_request_key(lm):
    """Sampled continuations depend on the request's uid-folded key and
    the seed, never on admission order."""
    cfg, params, _ = lm
    reqs = _trace(cfg, 4, seed=5, lens=(3, 10), new=(4, 7))
    sampler = SamplerConfig(kind="top_k", top_k=16)
    runs = []
    for seed, order in ((11, 1), (11, -1), (12, 1)):
        rt = ServeRuntime(cfg, params, max_slots=2, max_len=24,
                          sampler=sampler, seed=seed)
        for i, (p, n) in list(enumerate(reqs))[::order]:
            rt.submit(p, max_new_tokens=n, uid=i)
        runs.append(rt.run())
    for uid in runs[0]:
        np.testing.assert_array_equal(runs[0][uid], runs[1][uid])
    assert any(not np.array_equal(runs[0][u], runs[2][u]) for u in runs[0])


def test_eos_stops_a_request(lm):
    cfg, params, _ = lm
    p, _ = _trace(cfg, 1, seed=6, lens=(5, 6))[0]
    full = decode_lm(cfg, params, torch.as_tensor(p)[None], 6)[0].numpy()
    rt = ServeRuntime(cfg, params, max_slots=2, max_len=16,
                      eos_id=int(full[2]))
    uid = rt.submit(p, max_new_tokens=6)
    got = rt.run()[uid]
    stop = int(np.nonzero(full == full[2])[0][0])
    np.testing.assert_array_equal(got, full[:stop + 1])


def test_unported_runtime_options_raise(lm):
    """The device-state options are ported: they raise the reference's
    ``ValueError``s on a static pack together with a manager, and on a
    clock or heal policy without one."""
    from repro_torch.serve import DriftClock, HealPolicy

    cfg, params, pack = lm
    with pytest.raises(ValueError, match="not both"):
        ServeRuntime(cfg, params, pack=pack, manager=object())
    with pytest.raises(ValueError, match="need a manager"):
        ServeRuntime(cfg, params, clock=DriftClock(dt_per_step=1.0))
    with pytest.raises(ValueError, match="need a manager"):
        ServeRuntime(cfg, params, heal=HealPolicy())
    with pytest.raises(ValueError, match="attn_backend"):
        ServeRuntime(cfg, params, attn_backend="paged")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25
