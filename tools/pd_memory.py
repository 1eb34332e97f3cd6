#!/usr/bin/env python3
"""Where path PD's peak device memory arises: ``chip_smoke.py``'s main-path
set-up (qwen1.5-4b at published width, 4 layers, weights from seed 0,
4x32 calibration tokens) and its path PD's gates, on the card, with the
allocated and peak GiB printed before and after every ``PackManager``
method and every programming and calibration call inside the manager's
construction (the peak counter is reset at each print, so each "after"
line's peak is that call's own).  The healing trace is left out.

    python3 tools/pd_memory.py

Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

GIB = 2 ** 30


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pd_memory: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import fused as kern_fused
    from repro_torch.models import transformer as T
    from repro_torch.serve import health

    build.build_all()

    def mem(tag):
        torch.cuda.synchronize()
        print(f"{tag}: allocated {torch.cuda.memory_allocated() / GIB:.2f} "
              f"GiB, peak {torch.cuda.max_memory_allocated() / GIB:.2f} GiB",
              flush=True)
        torch.cuda.reset_peak_memory_stats()

    def reporting(fn, name):
        def call(*a, **kw):
            mem(f"before {name}")
            out = fn(*a, **kw)
            mem(f"after {name}")
            return out
        return call

    for name in ("__init__", "aged", "reprogram_band", "reprogram_head",
                 "recalibrate", "probe_loss", "program_band"):
        setattr(health.PackManager, name,
                reporting(getattr(health.PackManager, name), name))
    for name in ("lm_program_codes", "program_lm_from_codes", "calibrate_lm"):
        setattr(health, name, reporting(getattr(health, name), "  " + name))

    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=4)
    params = T.init_params(cfg, cs.SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    calib = torch.randint(0, cfg.vocab, (4, 32), generator=gen,
                          device="cuda")
    mem("parameters")
    cs.healing_trace = lambda *a, **kw: (
        0.0, 1.0, {"decode_steps": 0, "heal_events": 0,
                   "bands_reprogrammed": 0, "recalibrations": 0,
                   "probe_losses": []}, {})
    cs.path_pd(torch, cfg, params, cs.served_requests(cfg), calib,
               kern_fused)
    print(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
