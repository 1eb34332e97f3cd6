#!/usr/bin/env python3
"""Time the decode-attention kernels of one checkout — B2
(``flash_decode``, the dense cache) and B3 (``paged_attention``, a page
pool) — at qwen1.5-4b's widths from 32 to 32768 positions.

    python3 tools/attn_bench.py [--tree DIR] [--label NAME] [--step]
                                [--lengths N,N,...] [--set NAME=VALUE ...]
                                [--build-only] [--out FILE]

``--tree`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: this one), so two versions can be compared in one run on one
card: unpack the other into a git-ignored directory and run parent,
change, change, parent.  Shapes: 4 rows, 20 query and 20 KV heads, hd 128,
a bfloat16 cache, every row full at each length (32, 128, 512, 2048, 8192
and 32768 by default); the paged pool has pages of 16 positions behind a
shuffled block table, and the dense cache is its gathered view.  Each
output is held against its plain version under the flash-decode bound
(``tolerance.flash_decode_check``), and the paged kernel against the
flash-decode kernel on the gathered view (``torch.equal``).  Each kernel
and ``scaled_dot_product_attention`` over the same bf16 view are timed on
the device alone (``chip_smoke.graph_time``: a CUDA graph of ten launches
replayed between CUDA events), and each kernel's wrapper by CUDA events
around 50 calls, the least of five such runs, which time the host's work
per call where it is the longer (the least, since the host's clock is
shared with other work and only slows).  Prints one line per kernel and length (kernel ms, wrapper ms,
bound ms and its share, SDPA ms, the SM clock read just after) with the
card's name and power limit.  With ``--step`` it also builds
``chip_smoke.py``'s main-path pack (qwen1.5-4b, 4 layers, programmed and
calibrated) and times, as ``chip_smoke.py`` does, one ``decode_step`` of
the main path and one ``decode_step_paged`` of path PG at the served shape
(4 rows, max_len 32), and one ``decode_step_paged`` over 4 rows of 2048
positions of random pages (``chip_smoke.long_paged_step_s``).  Each
``--set NAME=VALUE`` times a variant of the tree's
``csrc/flash_decode.cu`` with the compile-time constant ``NAME`` (a
``constexpr int``, such as ``kStagesLong`` or ``kChunk``) set to
``VALUE``, built from a copy under ``build/attn_variants/``;
``--build-only`` builds it and exits, so variants can be compiled in
parallel before they are timed.  With ``--out`` the results are also
appended to FILE as one JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import kernel_tree as kt

B, KV, HD = 4, 20, 128           # 4 rows at qwen1.5-4b's attention widths
PAGE = 16
LENGTHS = (32, 128, 512, 2048, 8192, 32768)
WRAPPER_REPS, WRAPPER_RUNS = 50, 5


def case(torch, n: int, seed: int):
    """q, a shuffled bf16 pool of ``n`` positions a row (pages of
    ``PAGE``), its table, full fills, and the pool's gathered view."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    npg = -(-n // PAGE)
    shape = (1 + B * npg, PAGE, KV, HD)
    q = torch.randn((B, KV, HD), generator=gen, device="cuda")
    kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    ptab = (1 + torch.randperm(B * npg, generator=gen, device="cuda")) \
        .reshape(B, npg).to(torch.int32)
    lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
    view = [p[ptab.long()].reshape(B, npg * PAGE, KV, HD).contiguous()
            for p in (kp, vp)]
    return q, kp, vp, ptab, lens, view


def variant(build, sets) -> None:
    """Point ``build`` at a copy of the kernel sources whose
    ``flash_decode.cu`` has each ``NAME=VALUE`` of ``sets`` applied."""
    src = kt.set_constants((build.CSRC / "flash_decode.cu").read_text(),
                           sets, "flash_decode.cu")
    kt.build_copy(build, "flash_decode", src,
                  kt.HERE / "build" / "attn_variants"
                  / hashlib.sha256(src.encode()).hexdigest()[:12])


def steps(torch, cs, label: str) -> dict:
    """Build the main path's pack and time its decode steps: the main
    path's and path PG's at the served shape, PG's at 2048 positions."""
    from repro_torch.configs import get_config
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.models import transformer as T
    from repro_torch.serve import calibrate_lm, program_lm

    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=4)
    params = T.init_params(cfg, cs.SEED, device="cuda")
    spec = A.design_a(error=E.state_proportional(0.05), fused="kernel")
    pack = program_lm(cfg, params, spec, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    pack = calibrate_lm(cfg, params, pack, torch.randint(
        0, cfg.vocab, (4, 32), generator=gen, device="cuda"))
    out = {
        "main_step_ms": 1e3 * cs.decode_step_s(torch, cfg, params, pack,
                                               cs.served_requests(cfg)),
        "paged_step_ms": 1e3 * cs.paged_step_s(torch, cfg, params, pack),
        "long_paged_step_ms": 1e3 * cs.long_paged_step_s(torch, cfg, params,
                                                         pack)}
    print(f"{label} decode step, 4 rows, 4 layers: main "
          f"{out['main_step_ms']:.3f} ms, PG {out['paged_step_ms']:.3f} ms "
          f"(max_len {cs.MAX_LEN}); decode_step_paged at {cs.LONG_POS} "
          f"positions, page {cs.LONG_PAGE}: {out['long_paged_step_ms']:.3f} "
          f"ms", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(kt.HERE),
                    help="root of the checkout to time (default: this one)")
    ap.add_argument("--label", default="", help="name printed on each line")
    ap.add_argument("--lengths", default=",".join(map(str, LENGTHS)),
                    help="positions a row holds, comma-separated")
    ap.add_argument("--step", action="store_true",
                    help="also time the main and paged decode steps")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="time a variant with this kernel constant")
    ap.add_argument("--build-only", action="store_true",
                    help="build the (variant) kernel and exit")
    ap.add_argument("--out", default="", help="append a JSON line here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("attn_bench: no CUDA device", file=sys.stderr)
        return 2
    kt.use_tree(args.tree)
    import bitline_bench as bb
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import build, ops, tolerance as tol

    if args.set:
        variant(build, args.set)
    build.build_all(["flash_decode"])
    if args.build_only:
        return 0
    card = cs.card_line()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    ok = True
    for n in (int(x) for x in args.lengths.split(",")):
        q, kp, vp, ptab, lens, (gk, gv) = case(torch, n, cs.SEED + 70 + n)
        flash = ops.flash_attention_decode(q, gk, gv, lens)
        paged = ops.paged_attention(q, kp, vp, ptab, lens)
        r_flash = tol.flash_decode_check(flash, ops.flash_attention_decode(
            q, gk, gv, lens, backend="oracle"), gv, lens)
        r_paged = tol.paged_attention_check(paged, ops.paged_attention(
            q, kp, vp, ptab, lens, backend="oracle"), vp, ptab, lens)
        equal = bool(torch.equal(paged, flash))
        ok &= r_flash["ok"] and r_paged["ok"] and equal
        ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in (gk, gv))
        qs = q[:, :, None, :].to(ks.dtype)
        mask = (torch.arange(ks.shape[2], device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        lib = cs.graph_time(lambda: sdpa(qs, ks, vs, attn_mask=mask))
        b_ms, b_by = cs.bound_ms(*cs.paged_work(q, kp, ptab, lens))
        for name, call, r in (
                ("flash_decode", lambda: ops.flash_attention_decode(
                    q, gk, gv, lens), r_flash),
                ("paged_attention", lambda: ops.paged_attention(
                    q, kp, vp, ptab, lens), r_paged)):
            ms = cs.graph_time(call)
            wrapper = min(cs.cuda_time(call, reps=WRAPPER_REPS)
                          for _ in range(WRAPPER_RUNS))
            mhz = bb.sm_clock_mhz()
            row = {"kernel": name, "positions": n, "ms": ms,
                   "wrapper_ms": wrapper, "bound_ms": b_ms, "bound_by": b_by,
                   "sdpa_ms": lib, "sm_mhz": mhz, "within_bound": r["ok"],
                   "max_bound_frac": r["max_bound_frac"],
                   "paged_equals_flash": equal}
            rows.append(row)
            print(f"{args.label} {name} B={B} H={KV} KV={KV} hd={HD} bf16 "
                  f"positions={n}: kernel {ms:.4f} ms (device; wrapper "
                  f"{wrapper:.4f} ms)  bound {b_ms:.5f} ms ({b_by}, "
                  f"{b_ms / ms:.3f} of it)  sdpa {lib:.4f} ms  at {mhz:.0f} "
                  f"MHz  within bound {r['ok']} ({r['max_bound_frac']:.3f})  "
                  f"paged == flash {equal}", flush=True)
        del q, kp, vp, ptab, gk, gv, ks, vs
        torch.cuda.empty_cache()
    result = {"label": args.label, "set": args.set, "card": card,
              "rows": rows}
    if args.step:
        result.update(steps(torch, cs, args.label))
    print(f"{args.label} card: {card}", flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
