#!/usr/bin/env python3
"""Time the fused (B1), legacy Design-A (B7) and Design-D bit-serial (B8)
analog MVM kernels of one checkout at qwen1.5-4b's four full-width sites,
on the device alone.

    python3 tools/mvm_bench.py [--tree DIR] [--label NAME] [--out FILE]

``--tree`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: this one), so two versions can be compared in one run on one
card: unpack the other into a git-ignored directory and run parent,
change, change, parent.  Sites: wq (K 2560, N 2560), w_gate (K 2560,
N 6912), w_down (K 6912, N 2560) and the head (K 2560, N 151936), Design A
under 5% state-proportional error, weights and activations from fixed
seeds, at M = 4 (decode) and M = 128 (the prefill bucket); B8 at M = 4
with 7 input bits and the ADC range of its per-bit pre-ADC values, as
``chip_smoke.bitserial_full_width`` drives it.  Each call is
timed as a CUDA graph of ten launches replayed five times between CUDA
events (``chip_smoke.graph_time``), beside the wrapper's time per call
(CUDA events around ten calls, host work included), and held against its
plain version (``torch.equal``).  Prints one line per site and row count,
then the per-decode-step sums at 4 layers (wq's shape 16 calls, w_gate's
8, w_down's 4, the head 1) and B8's sum of one call per site, with the
card's name and power limit; with ``--out`` the results are also
appended to FILE as one JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import kernel_tree as kt

PER_STEP = {"wq": 16, "w_gate": 8, "w_down": 4, "head": 1}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(kt.HERE),
                    help="root of the checkout to time (default: this one)")
    ap.add_argument("--label", default="", help="name printed on each line")
    ap.add_argument("--out", default="", help="append a JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("mvm_bench: no CUDA device", file=sys.stderr)
        return 2
    kt.use_tree(args.tree)
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.core.adc import range_from_samples
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import fused_pre_adc

    build.build_all(["fused_mvm"])
    card = cs.card_line()
    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=4)
    spec = A.design_a(error=E.state_proportional(0.05))
    gain = (spec.mapping.levels_per_cell - 1) / (1.0 - spec.mapping.g_min)
    sites = [("wq", cfg.d_model, cfg.n_heads * cfg.hd),
             ("w_gate", cfg.d_model, cfg.d_ff),
             ("w_down", cfg.d_ff, cfg.d_model),
             ("head", cfg.d_model, cfg.vocab)]
    rows = []
    for i, (name, k, n) in enumerate(sites):
        gp, gm, inputs = cs.full_width_site(torch, A, E, k, n, (4, 128),
                                            cs.SEED + 100 + i)
        for x, lo, hi, scale in inputs:
            fkw = dict(adc_lo=lo, adc_hi=hi, adc_bits=8, cell_bits=7,
                       n_bits=None, scale=scale)
            lkw = dict(adc_lo=lo, adc_hi=hi, adc_bits=8, gain=gain)
            calls = {
                "fused_mvm": lambda b: ops.fused_mvm(x, gp, gm, backend=b,
                                                     **fkw),
                "analog_mvm_diff": lambda b: ops.analog_mvm(
                    x, gp[0], gm[0], backend=b, **lkw)}
            if x.shape[0] == 4:
                blo, bhi = range_from_samples(fused_pre_adc(x, gp, gm, 7))
                bkw = dict(n_bits=7, adc_lo=blo.reshape(1),
                           adc_hi=bhi.reshape(1), adc_bits=8, gain=gain)
                calls["analog_mvm_bitserial"] = \
                    lambda b: ops.analog_mvm_bitserial(x, gp[0], gm[0],
                                                       backend=b, **bkw)
            for kernel, call in calls.items():
                equal = bool(torch.equal(call("kernel"), call("oracle")))
                ms = cs.graph_time(lambda: call("kernel"))
                wrapper = cs.cuda_time(lambda: call("kernel"), reps=10)
                row = {"kernel": kernel, "site": name, "m": x.shape[0],
                       "device_ms": ms, "wrapper_ms": wrapper,
                       "equal": equal}
                rows.append(row)
                print(f"{args.label} {kernel} {name} M={x.shape[0]}: "
                      f"device {ms:.4f} ms  wrapper {wrapper:.4f} ms  "
                      f"equal to plain {equal}", flush=True)
        del gp, gm, inputs
        torch.cuda.empty_cache()
    step = {kn: sum(r["device_ms"] * PER_STEP[r["site"]] for r in rows
                    if r["kernel"] == kn and r["m"] == 4)
            for kn in ("fused_mvm", "analog_mvm_diff")}
    step["analog_mvm_bitserial (four sites)"] = sum(
        r["device_ms"] for r in rows if r["kernel"] == "analog_mvm_bitserial")
    print(f"{args.label} per decode step (M=4, 4 layers), device: "
          + "  ".join(f"{k} {v:.4f} ms" for k, v in step.items())
          + f"  on {card}", flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps({"label": args.label, "card": card,
                                "step_ms": step, "rows": rows}) + "\n")
    return 0 if all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
