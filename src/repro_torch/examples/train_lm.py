"""End-to-end driver: train a ~100M-param LM for a few hundred steps on the
synthetic pipeline with checkpointing, resume, fault tolerance and
straggler monitoring (port of ``examples/train_lm.py``, which this
follows as its code runs: the reference's docstring also promises an
analog evaluation that its code never makes).

Run: PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
     [--ckpt-dir DIR] [--device cpu]

A second run on the same ``--ckpt-dir`` resumes from its last checkpoint.
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import ModelConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.examples import BUILD, parser
from repro_torch.optim.adamw import cosine_schedule
from repro_torch.runtime.fault import StragglerMonitor, resilient_step
from repro_torch.train.step import make_train_state, train_step_fn

#: ~100M params: 8 layers x d=768 x ff=3072, 32k vocab
CONFIG = ModelConfig(name="lm-100m", family="dense", n_layers=8,
                     d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                     vocab=32000, dtype="float32", remat=False)


def train(cfg: ModelConfig, *, steps: int, ckpt_dir: str, device,
          seq_len: int = 128, global_batch: int = 16, microbatches: int = 2,
          save_every: int = 100, stop_after: Optional[int] = None,
          log=print):
    """Train ``cfg`` from seed 0 (or from the last checkpoint under
    ``ckpt_dir``) up to ``steps`` steps of ``global_batch`` x ``seq_len``
    ``SyntheticLM`` tokens (seed 0) in ``microbatches``, AdamW on a
    cosine schedule (3e-4, 20 warmup steps, over ``steps``); every
    ``save_every`` steps the state is saved asynchronously, the last two
    kept.  ``stop_after`` ends the run after that many steps of
    ``steps``, as an interrupted run would.  Returns (state, {"start",
    "losses", "step_s", "flagged"})."""
    ds = SyntheticLM(cfg=cfg, seq_len=seq_len, global_batch=global_batch,
                     seed=0, device=device)
    state = make_train_state(cfg, 0, device=device)
    sched = cosine_schedule(3e-4, warmup=20, total=steps)
    step = train_step_fn(cfg, microbatches=microbatches, lr_schedule=sched)
    mgr = CheckpointManager(ckpt_dir, keep_last=2)
    mon = StragglerMonitor()

    start = mgr.latest_step() or 0
    if start:
        state, start, _ = mgr.restore(state, device=device)
        log(f"resumed from step {start}")
    end = steps if stop_after is None else min(steps, stop_after)
    losses, step_s = [], []
    for i in range(start, end):
        t0 = time.perf_counter()
        state, m = resilient_step(step, state, ds.batch(i))
        loss = float(m["loss"])            # waits for the step
        dt = time.perf_counter() - t0
        mon.record(dt)
        losses.append(loss)
        step_s.append(dt)
        if i % 25 == 0 or i == steps - 1:
            log(f"step {i:4d} loss {loss:.4f} "
                f"gnorm {float(m['grad_norm']):.2f}")
        if i % save_every == save_every - 1:
            mgr.save_async(i + 1, state)
    mgr.wait()
    return state, {"start": start, "losses": losses, "step_s": step_s,
                   "flagged": len(mon.flagged), "kept": mgr.all_steps()}


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(BUILD, "train_lm"))
    args = ap.parse_args(argv)

    print(f"params ~{CONFIG.param_count()/1e6:.0f}M")
    _, out = train(CONFIG, steps=args.steps, ckpt_dir=args.ckpt_dir,
                   device=args.device)
    print(f"done; stragglers flagged: {out['flagged']}")
    if out["step_s"]:
        dt = statistics.median(out["step_s"])
        print(f"median step {1e3 * dt:.1f} ms, "
              f"{16 * 128 / dt:.0f} tokens/s")
    if torch.device(args.device).type == "cuda":
        print(f"peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return out


if __name__ == "__main__":
    main()
