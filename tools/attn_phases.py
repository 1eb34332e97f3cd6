#!/usr/bin/env python3
"""Where a CTA of the decode-attention kernel spends its time, on the card.

    python3 tools/attn_phases.py [--lengths N,N,...] [--set NAME=VALUE ...]

Copies ``src/repro_torch/kernels/csrc/flash_decode.cu`` into
``build/attn_phases/`` with ``clock64()`` counters around the phases of
``decode_attn_kernel`` (applying each ``--set`` as ``tools/attn_bench.py``
does), builds it with the package's nvcc flags, and drives it through the
port's own wrappers (``ops.paged_attention`` and
``ops.flash_attention_decode``) at qwen1.5-4b's widths: 4 rows, 20 KV heads,
hd 128, a bf16 pool of 16-position pages behind a shuffled table and its
gathered view, every row full at each length (128, 2048 and 8192 by
default).  Thread 0 of every CTA records, in SM cycles: the whole CTA, the
set-up before its first copy (the fill, the table, the query), the waits
for its stages (the slot's mbarrier and the stage barrier), the logits of
its K stages, the cluster's max with the materialization of p, the p * v
of its V stages, and the end (the cluster barrier and rank 0's fold); and,
from the global timer, when it started and ended.  What is left of a
CTA's time is the issue of its copies.  Prints the mean of each phase in
microseconds at the SM clock read just after, its share, the spread of
the CTAs' start times and the call's time by CUDA events.  The
product kernel is not changed; the script fails if the source no longer
has the lines it instruments.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import sys

import kernel_tree as kt
import numpy as np

OUT = kt.HERE / "build" / "attn_phases"
MAX_CTAS = 1 << 16
N_SLOTS = 9
PHASES = ("setup", "wait", "k", "max", "v", "fold")

#: (text in the source, its replacement), applied in turn; each text
#: occurs once.  The first: the K and V compute ends with the stage, the
#: last ``}`` pair closing the V branch and the stage loop
PROBES = [
    ("      }\n    }\n  }\n  if (!maxed) max_phase();",
     "      }\n    }\n    if (j < nK) ph_k += clock64() - ph_c;\n"
     "    else ph_v += clock64() - ph_c;\n  }\n  ph_x = clock64();\n"
     "  if (!maxed) max_phase();"),
    ("template <typename T, int G, typename Rows>\n__global__",
     f"__device__ long long g_phase[{MAX_CTAS} * {N_SLOTS}];\n"
     "__device__ __forceinline__ long long gtimer() {\n"
     "  long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n"
     "}\n\n"
     "template <typename T, int G, typename Rows>\n__global__"),
    ("  const int ns = gm.ns, sp = gm.sp, rb = gm.rb, rbs = gm.rbs;\n",
     "  const int ns = gm.ns, sp = gm.sp, rb = gm.rb, rbs = gm.rbs;\n"
     "  const long long ph_t0 = clock64(), ph_g0 = gtimer();\n"
     "  long long ph_x = 0, ph_setup = 0, ph_w = 0, ph_k = 0, ph_m = 0, "
     "ph_v = 0;\n"),
    ("  for (int j = 0; j < ns - 1; ++j) issue(j, j);\n",
     "  ph_setup = clock64() - ph_t0;\n"
     "  for (int j = 0; j < ns - 1; ++j) issue(j, j);\n"),
    ("    if (vec) mbar_wait(",
     "    ph_x = clock64();\n    if (vec) mbar_wait("),
    ("    issue(j + ns - 1, ",
     "    ph_w += clock64() - ph_x;\n    issue(j + ns - 1, "),
    ("      max_phase();\n      maxed = true;\n",
     "      ph_x = clock64();\n      max_phase();\n      maxed = true;\n"
     "      ph_m = clock64() - ph_x;\n"),
    ("    const unsigned char* slot = ring + (size_t)cs * sp * "
     "rbs;\n",
     "    const unsigned char* slot = ring + (size_t)cs * sp * "
     "rbs;\n    const long long ph_c = clock64();\n"),
    ("              __fdiv_rn(tot[gi][nd], fmaxf(den, 1e-30f));\n      }\n"
     "    }\n  }\n}\n",
     "              __fdiv_rn(tot[gi][nd], fmaxf(den, 1e-30f));\n      }\n"
     "    }\n  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    const long long blk = blockIdx.x + (long long)gridDim.x * "
     "(blockIdx.y + (long long)gridDim.y * blockIdx.z);\n"
     f"    if (blk < {MAX_CTAS}) {{\n"
     f"      long long* o = g_phase + {N_SLOTS} * blk;\n"
     "      const long long now = clock64();\n"
     "      o[0] = now - ph_t0; o[1] = ph_setup; o[2] = ph_w; o[3] = ph_k;\n"
     "      o[4] = ph_m; o[5] = ph_v; o[6] = now - ph_x; o[7] = ph_g0;\n"
     "      o[8] = gtimer();\n"
     "    }\n"
     "  }\n"
     "}\n"),
]
FETCH = ('\nextern "C" int repro_phases_get(long long* host, int n) {\n'
         '  return (int)cudaMemcpyFromSymbol(\n'
         f'      host, g_phase, (size_t)n * {N_SLOTS} * sizeof(long long));\n'
         '}\n')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lengths", default="128,2048,8192",
                    help="positions a row holds, comma-separated")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="instrument a variant with this kernel constant")
    args = ap.parse_args()

    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("attn_phases: no CUDA device", file=sys.stderr)
        return 2
    kt.use_tree(kt.HERE)
    import attn_bench as ab
    import bitline_bench as bb
    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    if args.set:
        ab.variant(build, args.set)
    src = kt.patch((build.CSRC / "flash_decode.cu").read_text(), PROBES,
                   "flash_decode.cu")
    kt.build_copy(build, "flash_decode", src + FETCH, OUT)
    build.build_all(["flash_decode"])
    lib = build.load("flash_decode")
    lib.repro_phases_get.argtypes = [ctypes.c_void_p, ctypes.c_int]
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    for n in (int(x) for x in args.lengths.split(",")):
        q, kp, vp, ptab, lens, (gk, gv) = ab.case(torch, n, cs.SEED + 70 + n)
        for name, call in (
                ("flash_decode", lambda: ops.flash_attention_decode(
                    q, gk, gv, lens)),
                ("paged_attention", lambda: ops.paged_attention(
                    q, kp, vp, ptab, lens))):
            ms = cs.cuda_time(call, reps=5)
            call()
            torch.cuda.synchronize()
            mhz = bb.sm_clock_mhz()
            n_ch = -(-n // 256)
            ctas = min(min(n_ch, 8) * ab.KV * ab.B, MAX_CTAS)
            buf = np.zeros((ctas, N_SLOTS), dtype=np.int64)
            if lib.repro_phases_get(buf.ctypes.data, ctas):
                raise RuntimeError("reading the counters failed")
            us = buf[:, :7].mean(axis=0) / mhz
            start = buf[:, 7] - buf[:, 7].min()
            span = (buf[:, 8].max() - buf[:, 7].min()) / 1e3
            phases = list(zip(PHASES, us[1:])) + [
                ("issue", us[0] - us[1:].sum())]
            parts = ", ".join(f"{p} {u:.2f} ({u / us[0]:.0%})"
                              for p, u in phases)
            print(f"{name} positions={n}: {ctas} CTAs, {ms * 1e3:.1f} us per "
                  f"call (events), {span:.1f} us first start to last end; per"
                  f" CTA {us[0]:.2f} us at {mhz:.0f} MHz: {parts}; CTA starts"
                  f" spread {start.max() / 1e3:.1f} us (median "
                  f"{np.median(start) / 1e3:.1f})", flush=True)
        del q, kp, vp, ptab, gk, gv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
