#!/usr/bin/env python3
"""Time the bit-line kernel (B5, ``bitline_mvm``) of one checkout at the
four shapes a qwen1.5-4b calibration under parasitics gives it.

    python3 tools/bitline_bench.py [--tree DIR] [--label NAME] [--out FILE]

``--tree`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: this one), so two versions can be compared in one run on one
card: unpack the other into a git-ignored directory and run parent,
change, change, parent.  Shapes: the arrays of wq (K 2560 in 3 partitions
of 854 rows, N 2560), w_gate (N 6912), w_down (K 6912 in 6 partitions of
1152 rows, N 2560) and the head (N 151936), each driven by the 7 signed
bit planes of 128 quantized activation rows per partition (896 plane
rows), at ``r_hat`` 1e-4 — the operands ``_apply_line`` hands the kernel
in path P2's calibration, which launches them 64, 32, 16 and 2 times at
4 layers.  Conductances are Design A under 5% state-proportional error,
weights and activations from fixed seeds (``chip_smoke.full_width_site``).
Each shape is held against its plain version (``torch.equal``) and timed
by CUDA events around three calls after one warm-up (a call takes 10 ms
or more, so the host's work per call is not what is timed).  Prints one
line per shape (kernel ms, bound ms, row steps per second, the SM clock
read just after the timing) and the sum over one calibration with the
card's name and power limit.  With ``--sass`` it also disassembles the
built kernel (``cuobjdump -sass``), counts the instructions one thread
issues per row step in the sweep's main loop (the loop body without the
divisions' slow-path calls, over the row steps one iteration sweeps:
half its reciprocals, as each row step issues two) and prints the issue ceiling that
count implies: 128 lanes per clock per SM (4 warp instructions), 132 SMs,
at the clock read.  With ``--out`` the results are also appended to FILE
as one JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import kernel_tree as kt

R_HAT = 1e-4
N_BITS = 7
ROWS = 128            # calibration activation rows per plane
#: (site, K, N, launches per calibration at 4 layers)
SHAPES = [("wq", 2560, 2560, 64), ("w_gate", 2560, 6912, 32),
          ("w_down", 6912, 2560, 16), ("head", 2560, 151936, 2)]
SMS, LANES = 132, 128         # H100 SXM: SMs; fp32 issue lanes per SM


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def sweep_loop_count(lib: Path, kernel: str = "bitline_mvm_kernel") -> dict:
    """Instructions per row step in the main loop of ``kernel`` (the first
    function of ``lib`` whose mangled name holds it): the body of the
    innermost loop (a backward branch with none inside it) that holds the
    most reciprocals (``MUFU.RCP``), without the slow-path blocks a forward
    branch skips (a ``CALL`` and no reciprocal), over the row steps one
    iteration sweeps: half its reciprocals, since each row step takes two
    (``c = -1 / denom`` and the one inside ``d / denom``); with the count
    of each opcode and the row steps."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    body = sass[sass.index(kernel):]
    body = body[:body.find("Function :", 1) if "Function :" in body[1:]
                else len(body)]
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    addr = [int(a, 16) for a, _ in ins]
    text = [t.strip() for _, t in ins]
    at = {a: i for i, a in enumerate(addr)}
    back = []
    for i, t in enumerate(text):
        m = re.search(r"BRA (?:`\()?(0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) < addr[i]:
            back.append((at[int(m.group(1), 16)], i))
    inner = [(sum("MUFU.RCP" in t for t in text[a:b]), a, b)
             for a, b in back
             if not any(a <= c and d < b for c, d in back if (c, d) != (a, b))]
    _, lo, hi = max(inner)
    done, i = [], lo
    while i <= hi:
        done.append(text[i])
        m = re.match(r"@!?P\d BRA (?:`\()?(0x[0-9a-f]+)", text[i])
        if m:
            j = at.get(int(m.group(1), 16), i)
            skip = " ".join(text[i + 1:j])
            if i < j <= hi and "CALL" in skip and "MUFU" not in skip:
                i = j
                continue
        i += 1
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
                              .split(".")[0] for t in done)
    steps = sum("MUFU.RCP" in t for t in done) // 2
    return {"per_row_step": len(done) / steps, "row_steps": steps,
            "ops": dict(ops.most_common())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(kt.HERE),
                    help="root of the checkout to time (default: this one)")
    ap.add_argument("--label", default="", help="name printed on each line")
    ap.add_argument("--out", default="", help="append a JSON line here")
    ap.add_argument("--sass", action="store_true",
                    help="count the sweep loop's instructions per row step")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bitline_bench: no CUDA device", file=sys.stderr)
        return 2
    kt.use_tree(args.tree)
    import chip_smoke as cs
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.fused import _bit_plane

    build.build_all(["bitline"])
    card = cs.card_line()
    rows = []
    for i, (name, k, n, per_cal) in enumerate(SHAPES):
        gp, _, inputs = cs.full_width_site(torch, A, E, k, n, (ROWS,),
                                           cs.SEED + 200 + i)
        x = inputs[0][0]                                    # (128, P, rows)
        sign, mag = torch.sign(x), x.abs()
        planes = torch.stack([_bit_plane(mag, sign, b)
                              for b in range(N_BITS)])      # (7, 128, P, r)
        p, kr = x.shape[1], x.shape[2]
        xp = planes.permute(2, 0, 1, 3).reshape(p, N_BITS * ROWS, kr) \
            .contiguous()
        g = gp[0].contiguous()                              # (P, rows, N)
        del inputs, planes, sign, mag
        got = ops.bitline_mvm(g, xp, R_HAT)
        want = ops.bitline_mvm(g, xp, R_HAT, backend="oracle")
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        del got, want
        ms = cs.cuda_time(lambda: ops.bitline_mvm(g, xp, R_HAT), reps=3,
                          warmup=1)
        mhz = sm_clock_mhz()
        n_g, m = g.shape[0], xp.shape[1]
        n_bytes = 4 * (xp.numel() + g.numel() + n_g * m * n)
        b_ms, b_by = cs.bound_ms(n_bytes, cs.sweep_ops(n_g * m * n, kr))
        steps = n_g * m * n * kr
        row = {"site": name, "g": list(g.shape), "x": list(xp.shape),
               "per_calibration": per_cal, "ms": ms, "bound_ms": b_ms,
               "bound_by": b_by, "row_steps_per_s": steps / (ms * 1e-3),
               "sm_mhz": mhz, "equal": equal}
        rows.append(row)
        print(f"{args.label} bitline_mvm {name}: g {tuple(g.shape)} x "
              f"{tuple(xp.shape)} x{per_cal}/calibration  kernel {ms:.4f} ms"
              f"  bound {b_ms:.4f} ms ({b_by})  {row['row_steps_per_s']:.4e}"
              f" row steps/s at {mhz:.0f} MHz  equal to plain {equal}",
              flush=True)
        del gp, g, xp
        torch.cuda.empty_cache()
    cal = sum(r["ms"] * r["per_calibration"] for r in rows)
    cal_bound = sum(r["bound_ms"] * r["per_calibration"] for r in rows)
    print(f"{args.label} bitline_mvm per calibration: {cal:.3f} ms, bound "
          f"{cal_bound:.3f} ms ({cal_bound / cal:.3f} of the bound) on "
          f"{card}", flush=True)
    result = {"label": args.label, "card": card, "calibration_ms": cal,
              "calibration_bound_ms": cal_bound, "rows": rows}
    if args.sass:
        sass = sweep_loop_count(build.library_path("bitline"))
        mhz = max(r["sm_mhz"] for r in rows)
        ceiling = LANES / sass["per_row_step"] * SMS * mhz * 1e6
        steps = sum(r["row_steps_per_s"] * r["ms"] * 1e-3
                    * r["per_calibration"] for r in rows)
        sass.update(sm_mhz=mhz, ceiling_row_steps_per_s=ceiling,
                    ceiling_calibration_ms=steps / ceiling * 1e3)
        result["sass"] = sass
        print(f"{args.label} bitline_mvm SASS: {sass['per_row_step']:.2f} "
              f"instructions per row step ({sass['ops']}); issue ceiling "
              f"{ceiling:.4e} row steps/s at {mhz:.0f} MHz, "
              f"{sass['ceiling_calibration_ms']:.3f} ms per calibration",
              flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return 0 if all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
