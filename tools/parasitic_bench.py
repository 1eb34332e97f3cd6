#!/usr/bin/env python3
"""Time the parasitic fold kernels of one checkout — B4
(``fused_mvm_parasitic``) and B6 (``analog_bitline_diff``) — at the four
site shapes of one qwen1.5-4b decode step.

    python3 tools/parasitic_bench.py [--tree DIR] [--label NAME] [--sass]
                                     [--out FILE]

``--tree`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: this one), so two versions can be compared in one run on one
card: unpack the other into a git-ignored directory and run parent,
change, change, parent.  Shapes: wq (K 2560 in 3 partitions of 854 rows,
N 2560), w_gate (N 6912), w_down (K 6912 in 6 partitions of 1152 rows,
N 2560) and the head (N 151936), at M = 4 token rows, 7 input bits and
``r_hat`` 1e-4, launched 16, 8, 4 and 1 times per decode step at 4
layers.  Conductances are Design A under 5% state-proportional error,
weights and activations from the seeds ``chip_smoke.py`` uses
(``chip_smoke.full_width_site``), ADC ranges from the plain pre-ADC
values.  Each output is held against its plain version (``torch.equal``);
each kernel is timed on the device alone (``chip_smoke.graph_time``: a
CUDA graph of ten launches replayed between CUDA events).  Prints one line
per kernel and shape (kernel ms, bound ms, row steps per second, the SM
clock read just after the timing) and each kernel's sum over one decode
step with the card's name and power limit.  With ``--sass`` it also counts
the instructions one thread issues per row step in each kernel's sweep
loop (``tools/bitline_bench.py``'s counter, which takes an iteration's
row steps from its reciprocals) and prints the issue ceiling that count
implies.  With ``--out`` the results are also
appended to FILE as one JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys

import kernel_tree as kt

R_HAT = 1e-4
M = 4                 # decode rows (4 serving slots)
N_BITS = 7
#: (site, K, N, launches per decode step at 4 layers)
SHAPES = [("wq", 2560, 2560, 16), ("w_gate", 2560, 6912, 8),
          ("w_down", 6912, 2560, 4), ("head", 2560, 151936, 1)]
#: mangled-name fragments of the fold kernel's two instances (the fused
#: epilogue, the legacy one) in the built fused_mvm_parasitic library
SASS_NAMES = {"fused_mvm_parasitic": "parasitic_fold_kernelILb0E",
              "analog_bitline_diff": "parasitic_fold_kernelILb1E"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(kt.HERE),
                    help="root of the checkout to time (default: this one)")
    ap.add_argument("--label", default="", help="name printed on each line")
    ap.add_argument("--out", default="", help="append a JSON line here")
    ap.add_argument("--sass", action="store_true",
                    help="count each sweep loop's instructions per row step")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("parasitic_bench: no CUDA device", file=sys.stderr)
        return 2
    kt.use_tree(args.tree)
    import bitline_bench as bb
    import chip_smoke as cs
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.core.adc import range_from_samples
    from repro_torch.kernels import build, ops, tolerance as tol
    from repro_torch.kernels.ref import parasitic_pre_adc

    build.build_all()
    card = cs.card_line()
    spec = A.design_a(error=E.state_proportional(0.05))
    gain = (spec.mapping.levels_per_cell - 1) / (1.0 - spec.mapping.g_min)
    r = torch.tensor(R_HAT, device="cuda")    # on the card: graph-capturable
    rows = []
    for i, (site, k, n, per_step) in enumerate(SHAPES):
        gp, gm, inputs = cs.full_width_site(torch, A, E, k, n, (M,),
                                            cs.SEED + 200 + i)
        x, _, _, scale = inputs[0]
        p, kr = x.shape[1], x.shape[2]
        lo, hi = (t.reshape(1) for t in range_from_samples(
            parasitic_pre_adc(x, gp, gm, r, N_BITS)))
        systems = 2 * N_BITS * M * p * n
        for name, (call, _, n_bytes, n_flops) in cs.parasitic_calls(
                ops, tol, x, gp, gm, lo, hi, scale, gain, N_BITS,
                r_hat=r).items():
            b_ms, b_by = cs.bound_ms(n_bytes, n_flops)
            equal = bool(torch.equal(call("kernel"), call("oracle")))
            ms = cs.graph_time(lambda: call("kernel"))
            mhz = bb.sm_clock_mhz()
            row = {"kernel": name, "site": site, "m": M, "p": p, "rows": kr,
                   "n": n, "per_step": per_step, "ms": ms, "bound_ms": b_ms,
                   "bound_by": b_by,
                   "row_steps_per_s": systems * kr / (ms * 1e-3),
                   "sm_mhz": mhz, "equal": equal}
            rows.append(row)
            print(f"{args.label} {name} {site}: M={M} P={p} rows={kr} N={n} "
                  f"x{per_step}/step  kernel {ms:.4f} ms  bound {b_ms:.4f} "
                  f"ms ({b_by})  {row['row_steps_per_s']:.4e} row steps/s "
                  f"at {mhz:.0f} MHz  equal to plain {equal}", flush=True)
        del gp, gm, inputs, x
        torch.cuda.empty_cache()
    result = {"label": args.label, "card": card, "rows": rows}
    for name in SASS_NAMES:
        mine = [rw for rw in rows if rw["kernel"] == name]
        step = sum(rw["ms"] * rw["per_step"] for rw in mine)
        bound = sum(rw["bound_ms"] * rw["per_step"] for rw in mine)
        steps = sum(rw["row_steps_per_s"] * rw["ms"] * 1e-3 * rw["per_step"]
                    for rw in mine)
        result[name] = {"step_ms": step, "step_bound_ms": bound,
                        "row_steps_per_s": steps / (step * 1e-3)}
        print(f"{args.label} {name} per decode step: {step:.3f} ms, bound "
              f"{bound:.3f} ms ({bound / step:.3f} of the bound), "
              f"{steps / (step * 1e-3):.4e} row steps/s on {card}",
              flush=True)
        if args.sass:
            sass = bb.sweep_loop_count(
                build.library_path("fused_mvm_parasitic"), SASS_NAMES[name])
            mhz = max(rw["sm_mhz"] for rw in mine)
            ceiling = bb.LANES / sass["per_row_step"] * bb.SMS * mhz * 1e6
            sass.update(sm_mhz=mhz, ceiling_row_steps_per_s=ceiling,
                        ceiling_step_ms=steps / ceiling * 1e3)
            result[name]["sass"] = sass
            print(f"{args.label} {name} SASS: {sass['per_row_step']:.2f} "
                  f"instructions per row step ({sass['ops']}); issue "
                  f"ceiling {ceiling:.4e} row steps/s at {mhz:.0f} MHz, "
                  f"{sass['ceiling_step_ms']:.3f} ms per decode step",
                  flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return 0 if all(rw["equal"] for rw in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
