#!/usr/bin/env python3
"""Where one decode step's time goes: the main path's dense step and path
PG's paged step of ``chip_smoke.py``, on the card, under ``torch.profiler``.

    python3 tools/step_profile.py [--layers N] [--steps S] [--trace DIR]

Builds the main path's model as ``chip_smoke.py`` does (qwen1.5-4b at
published width, weights from seed 0, depth cut to ``--layers``, Design A
under 5% state-proportional error, ``fused="kernel"``, calibrated on 4x32
tokens), prefills 4 rows, then times ``--steps`` decode steps of each
path: the wall time of a step (host clock around work that ends in
``torch.cuda.synchronize()``), and, from one profiled run of the same
steps, the device's busy time (the union of the kernels' intervals), its
idle share, the host's time inside the step function before it returns
(the enqueue), the kernels by device time and the host operators by
self CPU time.  With ``--trace`` a Chrome trace of each profiled run is
written there.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from pathlib import Path

import kernel_tree as kt


def busy_ms(events) -> float:
    """Milliseconds covered by the union of the device events' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def profile_steps(torch, name, step, n_steps, trace_dir):
    """Wall times of ``n_steps`` calls of ``step`` (each synchronized),
    then one profiled run of as many: prints and returns a summary."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls, enqueue = [], []
    for _ in range(n_steps):
        t = time.perf_counter()
        step()
        enqueue.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
            torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type.name == "CUDA"]
    wall = statistics.median(walls) * 1e3
    busy = busy_ms(dev) / n_steps
    print(f"{name}: step {wall:.3f} ms wall (median of {n_steps}), host "
          f"enqueue {statistics.median(enqueue) * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms per step, idle share {1 - busy / wall:.3f}; "
          f"{len(dev) / n_steps:.0f} device events per step", flush=True)
    if not dev:
        print(f"{name}: the profiler recorded no device time", flush=True)
    by_kernel = {}
    for e in dev:
        by_kernel.setdefault(e.name[:60], [0, 0.0])
        by_kernel[e.name[:60]][0] += 1
        by_kernel[e.name[:60]][1] += (e.time_range.end
                                      - e.time_range.start) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    for k, (n, ms) in top:
        print(f"  device {ms / n_steps:8.3f} ms/step  {n / n_steps:5.1f}/step"
              f"  {k}", flush=True)
    cpu = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in cpu[:15]:
        print(f"  host   {e.self_cpu_time_total / 1e3 / n_steps:8.3f} ms/step"
              f"  {e.count / n_steps:6.1f}/step  {e.key[:60]}", flush=True)
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / f"{name}.json"))
    return {"wall_ms": wall, "busy_ms": busy}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace", default="", help="write Chrome traces here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    kt.use_tree(kt.HERE)
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.models import transformer as T
    from repro_torch.serve import PagedServeRuntime, calibrate_lm, program_lm

    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=args.layers)
    params = T.init_params(cfg, cs.SEED, device="cuda")
    spec = A.design_a(error=E.state_proportional(0.05), fused="kernel")
    pack = program_lm(cfg, params, spec, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    calib = torch.randint(0, cfg.vocab, (4, 32), generator=gen, device="cuda")
    pack = calibrate_lm(cfg, params, pack, calib)
    print(f"card: {cs.card_line()}; {cfg.name}, {cfg.n_layers} layers, 4 "
          f"rows", flush=True)

    rng = np.random.default_rng(cs.SEED + 2)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, size=(4, 3)),
                              device="cuda")
    _, cache = T.prefill(cfg, params, prompts, cs.MAX_LEN, pack=pack)
    tok = torch.zeros((4, 1), dtype=torch.long, device="cuda")

    def dense_step():
        # the K/V are written in place at the unchanged fill, so every
        # step writes and attends over the same positions
        logits, _ = T.decode_step(cfg, params, tok, cache, pack=pack,
                                  attn_backend="flash")
        return torch.argmax(logits[:, -1], dim=-1)

    profile_steps(torch, "dense", dense_step, args.steps, args.trace)

    rt = PagedServeRuntime(cfg, params, pack=pack, page_size=cs.PAGE_SIZE,
                           max_slots=4, max_len=cs.MAX_LEN, backend="kernel")
    for _ in range(4):
        rt.submit(rng.integers(0, cfg.vocab, size=3).astype(np.int32),
                  max_new_tokens=cs.MAX_LEN - 3)
    rt.step()
    st = rt._state
    pcache = {"pool": st.layers, "len": st.length,
              "ptab": torch.as_tensor(rt._ptab, device="cuda")}

    def paged_step():
        logits, _ = T.decode_step_paged(cfg, params, tok, pcache, pack=pack,
                                        backend="kernel")
        return torch.argmax(logits[:, -1], dim=-1)

    profile_steps(torch, "paged", paged_step, args.steps, args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
