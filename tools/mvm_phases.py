#!/usr/bin/env python3
"""Where a block of the streaming MVM kernel spends its cycles, on the card.

    python3 tools/mvm_phases.py

Copies ``src/repro_torch/kernels/csrc/fused_mvm.cu`` into
``build/mvm_phases/`` with ``clock64()`` counters inserted around the
phases of ``mvm_stream_kernel``'s stage loop, builds it with the package's
nvcc flags, and calls its ``repro_fused_mvm`` (analog mode, Design A
shapes of qwen1.5-4b: wq, w_gate, w_down and the head at M = 4, wq and
the head at M = 128; random operands from a seed).  Thread 0 of every
block records, in SM cycles: the whole block, the wait for its own
copies plus the g conversion plus the stage barrier, the issue of the
next stage's copies, the row loop, and the two cluster barriers with the
partition sum.  Prints the mean over blocks of each, its share, and the
call's time by CUDA events.  The product kernel is not changed; the
script fails if the source no longer has the lines it instruments.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import kernel_tree as kt
import numpy as np

CSRC = kt.HERE / "src" / "repro_torch" / "kernels" / "csrc"
OUT = kt.HERE / "build" / "mvm_phases"
MAX_BLOCKS = 65536

#: (anchor line, text inserted before it, text inserted after it)
PROBES = [
    ("template <int BM, int TM, int TN, int NB, bool LEGACY>\n__global__",
     f"__device__ long long g_phase[{MAX_BLOCKS} * 5];\n", ""),
    ("  float tot[TM][TN];\n", "",
     "  long long ph_t0 = clock64(), ph_w = 0, ph_i = 0, ph_c = 0, "
     "ph_k = 0, ph_x = 0;\n"),
    ("        cp_async_wait<kStages - 2>();       // this thread's stage t "
     "landed\n", "        ph_x = clock64();\n", ""),
    ("        __syncthreads();                    // stage t's g and x "
     "visible;\n", "", "        ph_w += clock64() - ph_x; ph_x = clock64();\n"),
    ("        const int s = t / nst, r0 = (t - s * nst) * kTileR;\n"
     "        const int rc", "        ph_i += clock64() - ph_x; "
     "ph_x = clock64();\n", ""),
    ("        if (t - s * nst != nst - 1) continue;\n",
     "        ph_c += clock64() - ph_x;\n", ""),
    ("    cluster.sync();                 // every partition result of the "
     "round\n", "    ph_x = clock64();\n", ""),
    ("    cluster.sync();                 // rank 0 has read them\n", "",
     "    ph_k += clock64() - ph_x;\n"),
    ("  if (rank != 0) return;\n",
     "  if (threadIdx.x == 0) {\n"
     "    const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y"
     " * blockIdx.z);\n"
     f"    if (blk < {MAX_BLOCKS}) {{\n"
     "      long long* o = g_phase + 5 * blk;\n"
     "      o[0] = clock64() - ph_t0; o[1] = ph_w; o[2] = ph_i; o[3] = ph_c;"
     " o[4] = ph_k;\n"
     "    }\n"
     "  }\n", ""),
]
FETCH = ('\nextern "C" int repro_phases_get(long long* host, int n) {\n'
         '  return (int)cudaMemcpyFromSymbol(host, g_phase,\n'
         '                                   (size_t)n * 5 * sizeof(long long));\n'
         '}\n')
#: (site, K, N, M); Design A arrays of 854 rows for K = 2560, 1152 else
CASES = [("wq", 2560, 2560, 4), ("w_gate", 2560, 6912, 4),
         ("w_down", 6912, 2560, 4), ("head", 2560, 151936, 4),
         ("wq", 2560, 2560, 128), ("head", 2560, 151936, 128)]


def instrumented_source() -> str:
    edits = [(anchor, before + anchor + after)
             for anchor, before, after in PROBES]
    return kt.patch((CSRC / "fused_mvm.cu").read_text(), edits,
                    "fused_mvm.cu") + FETCH


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mvm_phases: no CUDA device", file=sys.stderr)
        return 2
    kt.use_tree(kt.HERE)
    import chip_smoke as cs
    from repro_torch.kernels import build

    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "fused_mvm_phases.cu", OUT / "fused_mvm_phases.so"
    cu.write_text(instrumented_source())
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(CSRC),
                    "-o", str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.repro_fused_mvm.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                                    + [ctypes.c_void_p])
    lib.repro_phases_get.argtypes = [ctypes.c_void_p, ctypes.c_int]
    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for name, k, n, m in CASES:
        rows = 854 if k == 2560 else 1152
        p = -(-k // rows)
        x = torch.randint(-127, 128, (m, p, rows), generator=gen,
                          device=dev).float()
        gp = torch.rand((1, p, rows, n), generator=gen, device=dev) * 0.1
        gm = torch.rand((1, p, rows, n), generator=gen, device=dev) * 0.1
        lo, hi, sc = (torch.tensor([v], device=dev) for v in (-60., 60., 3e-4))
        y = torch.empty((m, n), device=dev)

        def call():
            rc = lib.repro_fused_mvm(
                x.data_ptr(), gp.data_ptr(), gm.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), sc.data_ptr(), y.data_ptr(), m, p, rows, n, 1,
                0, 8, 7, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        ms = cs.cuda_time(call, reps=5)
        bm = 4 if m <= 4 else 16 if m <= 16 else 128
        blocks = min(min(p, 8) * -(-n // 64) * -(-m // bm), MAX_BLOCKS)
        buf = np.zeros((blocks, 5), dtype=np.int64)
        if lib.repro_phases_get(buf.ctypes.data, blocks):
            raise RuntimeError("reading the counters failed")
        tot, wait, issue, rows_, clus = buf.mean(axis=0)
        print(f"{name} M={m} P={p} N={n}: {blocks} blocks, {ms * 1e3:.1f} "
              f"us per call (events); per block {tot:.0f} cycles: wait + "
              f"convert + barrier {wait / tot:.0%}, issue {issue / tot:.0%}, "
              f"row loop {rows_ / tot:.0%}, cluster {clus / tot:.0%}, rest "
              f"{1 - (wait + issue + rows_ + clus) / tot:.0%}", flush=True)
        del x, gp, gm, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
