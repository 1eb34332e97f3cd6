"""The readings a cell's limits are set from, in one process.

    python3 portbench/harness/readings.py --workload <cell> \\
        --seconds <s> --seeds 1,2,3 [--controls 4,5,6]

Each seed is a run of the cell as ``run.py`` makes it, its window cut to
``--seconds`` (long enough for the one point a run compares); it prints
the compared numbers of the port against the plain reference.  A control
seed prints, besides, those of the reference with its arrays' operands
rounded to TF32 against the reference, on the same point.  Set-up,
kernels included, is paid once."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1] / "src")]

from harness import common, sweep  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--controls", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = common.Cell.named(args.workload)
    seeds = [(int(s), False) for s in args.seeds.split(",") if s]
    seeds += [(int(s), True) for s in args.controls.split(",") if s]
    for n, (seed, lower) in enumerate(seeds):
        t0 = time.perf_counter()
        _, numbers, rec = sweep.run(cell, seed, args.seconds, False, device,
                                    t0, warm=n == 0, lower_too=lower)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "sound": numbers, "control": rec["control"],
                          "points": rec["points_done"],
                          "point_s": rec["end_to_end"]["point_s"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
