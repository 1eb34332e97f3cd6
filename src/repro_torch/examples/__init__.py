"""``repro_torch.examples`` — the reference's six example scripts as the
port's entry points (counterparts of ``examples/*.py``).

Each runs as ``python -m repro_torch.examples.<name>`` and on the card
unless ``--device cpu`` is passed:

* ``quickstart`` — Design A against the offset Design E on one Laplace
  matrix, with SONOS errors and calibration;
* ``hetero_profile`` — one smoke LM served through per-site hardware (an
  8-bit attention class, a 6-bit MLP class, a digital head) and its
  per-site ADC energy;
* ``analog_serve`` — three designs' analog loss and greedy agreement;
* ``serve_loop`` — ``ServeRuntime`` draining ten mixed requests with top-k
  sampling;
* ``design_space`` — the five named designs swept through
  ``repro_torch.sweep`` and priced by ``core.energy``, on the trained
  classifier of :mod:`repro_torch.examples.classifier`;
* ``train_lm`` — a ~100M-parameter LM trained with checkpoints, resume,
  ``resilient_step`` and ``StragglerMonitor``.

They keep the reference's sizes, steps, seeds' roles, specs and printed
lines; a ``jax.random`` key becomes an integer seed (``torch.Generator``
cannot reproduce ``jax.random``'s draws).  Each splits into a function
that builds or trains its model and one that evaluates given parameters
(and a programmed pack), so that the tests can hold the evaluation on
the reference's parameters and conductances.  The examples keep
``fused="off"`` and ``attn_backend="stream"``, as the reference's do:
they launch none of the port's kernels.

This module holds what several examples share: the device flag and the
smoke-LM training loop.
"""

from __future__ import annotations

import argparse
import os

from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.train.step import make_train_state, train_step_fn

#: where the examples write (trained weights, sweep caches, checkpoints):
#: ``build/examples`` at the root of the checkout, which git ignores
BUILD = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    os.pardir, "build", "examples"))


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--device`` flag."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    return ap


def train_smoke_lm(arch: str, seq_len: int, steps: int, *, device):
    """The reference examples' tiny LM: ``arch``'s smoke config trained
    for ``steps`` steps of 8 x ``seq_len`` tokens of ``SyntheticLM`` (seed
    0) at lr 3e-3 from seed 0.  Returns (cfg, dataset, params, final
    loss)."""
    cfg = get_smoke_config(arch)
    ds = SyntheticLM(cfg=cfg, seq_len=seq_len, global_batch=8, seed=0,
                     device=device)
    state = make_train_state(cfg, 0, device=device)
    step = train_step_fn(cfg, microbatches=1, lr=3e-3)
    m = None
    for i in range(steps):
        state, m = step(state, ds.batch(i))
    return cfg, ds, state.params, float(m["loss"])
