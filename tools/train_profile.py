#!/usr/bin/env python3
"""Where one training step's time goes: ``chip_smoke.py``'s path TR on the
card, by phase and under ``torch.profiler``.

    python3 tools/train_profile.py [--layers N] [--steps S] [--trace DIR]

Builds path TR's model and step as ``chip_smoke.py`` does (qwen1.5-4b at
published width, weights from seed 0, depth cut to ``--layers``, bf16
activations over fp32 masters, remat on, 2 x 4096 tokens in 2
microbatches, AdamW under ``cosine_schedule(3e-4, 2, 8)``) and prints:
the phases of one step, each timed to a synchronize (median of three):
one microbatch's forward and backward with and without remat, the
gradient accumulation, division and clipping, and the AdamW update; then
the whole step's wall time and, from a profiled run of ``--steps``
steps, the device's busy time, its idle share, the kernels by device time
and the host operators by self CPU time (``tools/step_profile.py``'s
``profile_steps``).  With ``--trace`` a Chrome trace is written there.
Needs a CUDA card; no kernel of ``csrc/`` runs here.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time

import kernel_tree as kt
from step_profile import profile_steps


def median_s(torch, fn, reps: int = 3) -> float:
    """Median seconds of ``fn()`` over ``reps`` calls, each ending in a
    synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--trace", default="", help="write a Chrome trace here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    kt.use_tree(kt.HERE)
    import chip_smoke as cs
    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.core.quant import true_div
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.pytree import tree_map
    from repro_torch.train import step as TS

    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=args.layers)
    seq = SHAPES["train_4k"].seq_len
    state = TS.make_train_state(cfg, cs.SEED, device="cuda")
    ds = SyntheticLM(cfg, seq, cs.TR_BATCH, seed=0, device="cuda")
    batch = ds.batch(0)
    mb = {k: v[:cs.TR_BATCH // cs.TR_MICRO] for k, v in batch.items()}
    print(f"card: {cs.card_line()}; {cfg.name}, {cfg.n_layers} layers, "
          f"{cs.TR_BATCH} x {seq} tokens in {cs.TR_MICRO} microbatches",
          flush=True)

    phases = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        phases[f"fwd+bwd, 1 microbatch, remat {remat}"] = median_s(
            torch, lambda: TS.loss_and_grads(c, state.params, mb))
    _, _, grads = TS.loss_and_grads(cfg, state.params, mb)

    def accumulate_and_clip():
        acc = tree_map(torch.zeros_like, grads)
        for _ in range(cs.TR_MICRO):
            tree_map(lambda a, g: a.add_(g), acc, grads)
        acc = tree_map(lambda g: true_div(g, cs.TR_MICRO), acc)
        return adamw.clip_by_global_norm(acc, 1.0)

    phases["accumulate, divide, clip"] = median_s(torch, accumulate_and_clip)
    phases["AdamW update"] = median_s(
        torch, lambda: adamw.update(grads, state.opt, state.params, lr=1e-4))
    del grads
    torch.cuda.empty_cache()
    step_fn = cs.tr_step_fn(cfg, cs.TR_MICRO)
    box = {"state": state}
    del state

    def step():
        box["state"], _ = step_fn(box["state"], batch)

    phases["whole step"] = median_s(torch, step)
    for name, s in phases.items():
        print(f"phase {name}: {s * 1e3:.1f} ms", flush=True)
    profile_steps(torch, "train_step", step, args.steps, args.trace)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
