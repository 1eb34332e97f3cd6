#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA.  Phases, each printing its own
lines:

1. card and build — the card's name and power limit (nvidia-smi), then
   every CUDA source of ``src/repro_torch/kernels/csrc`` built for sm_90a,
   one nvcc each, all at once, with ptxas's register report;
2. kernel vs plain — each kernel against its plain PyTorch version on the
   card, on the CPU test grids (``tolerance.*_GRID``) and at qwen1.5-4b's
   full-width decode shapes, held to the bounds of
   ``repro_torch.kernels.tolerance``, with the kernel's time, the plain
   version's, the least time the card could take (bound) and one PyTorch
   library call computing the same function or its dot part (yardstick
   only; no PyTorch call solves a bit line, so the parasitic kernels have
   none); each fused and parasitic site is also checked and timed at a
   full prefill bucket (4 slots x the cache length); the fused, legacy
   Design-A, fused parasitic and legacy parasitic kernels must equal their
   plain versions to the bit at both row counts; the fused and legacy
   Design-A kernels are timed on the device alone (a CUDA graph of ten
   launches, as are their torch.matmul yardsticks) beside the wrapper's
   time per call; the flash-decode kernel is held and timed on the device
   (as is ``scaled_dot_product_attention`` over the bf16 cache) beside the
   wrapper's time per call at the served shape and at 4 rows x 2048
   positions, and both attention kernels are held on
   ``tolerance.ATTN_EDGE_GRID`` (the edges of their split of positions over
   a cluster, up to 32768 positions), also against float64; the bit-line
   kernel, which runs only in calibration, is held in phase 5 at the shapes
   that gives it;
3. main path — qwen1.5-4b at its published width (weights from a seed,
   depth cut to ``--layers``, default 4 of 40) programmed with Design A
   under 5% state-proportional error and ``fused="kernel"``, calibrated,
   and serving mixed-length greedy requests through
   ``ServeRuntime(attn_backend="flash")``; both kernels' launch counts are
   read from that run; the runtime must equal ``decode_lm`` token for
   token, and the served logits must agree with the plain-version pack;
4. path P1 — the same programmed conductances (programming does not depend
   on the parasitic level) under bit-line parasitics, ``r_hat`` 1e-4 (the
   middle of the paper's Fig. 19 axis), ``fused="kernel"``: recalibrated
   and serving the same requests; the fused parasitic kernel's launches are
   read from that run, the runtime must equal ``decode_lm``, the served
   logits must agree with the plain-version pack, and the decode step is
   timed;
5. path P2 — the legacy ``use_pallas=True, fused="off"`` route on the same
   conductances, at ``r_hat`` 1e-4 (the bit-line kernel in calibration,
   the legacy parasitic kernel in serving) and at ``r_hat`` 0 (the legacy
   Design-A kernel), each recalibrated and serving three requests that
   must equal ``decode_lm``; one prefill's logits must equal the same
   pack's on the legacy kernels' plain versions, the decode step is timed
   at 4 rows, and the bit-line kernel is held against its plain version
   (to the bit), and timed, on one call of each shape the calibration
   gave it (its times summed over one calibration);
6. path PG — paged serving with prefix sharing: the main path's programmed
   and calibrated pack served through ``PagedServeRuntime(page_size=8,
   max_slots=4, max_len=32)``, the main path's five requests and three
   that open with the 24-token prompt's first 16 tokens (two full pages);
   ``backend="gather"`` must equal the dense ``ServeRuntime`` token for
   token, ``backend="kernel"`` must equal ``decode_lm`` but at near ties,
   hit the prefix cache through ``prefill_cached`` and launch the
   paged-attention kernel once per layer per decode step (and the
   flash-decode kernel never); its decode step is timed at 4 rows, and
   again over a pool of random pages at 2048 positions a row (a time only,
   no tokens compared).  The paged-attention kernel is held against its
   plain version on ``tolerance.PAGED_GRID`` and at the served shape,
   against the flash-decode kernel on the gathered view (to the bit), and
   timed on the device, beside the wrapper's time per call, at the served
   shape and at 4 rows x 2048 positions;
7. Design D — no serving path reaches the bit-serial kernel, so its op
   entry point (``ops.analog_mvm_bitserial``) is driven once at each of
   wq, w_gate, w_down and the head of the main path's pack (slice 0 of its
   conductances, 4 quantized activation rows, 7 bits), counts reset just
   before and read just after; it is held against its plain version (to
   the bit) on ``tolerance.BITSERIAL_GRID`` and at those four sites, and
   timed there on the device alone (a CUDA graph of ten launches, as is
   its ``torch.matmul`` yardstick) beside the wrapper's time per call;
7a. phase AN — the static analyzer and its contracts
   (``repro_torch.analysis``) on the main path's full-width pack: AN1 the
   lint of ``src/repro_torch`` (Python and ``csrc``) and the five static
   contracts, zero findings; AN2 ``serve/decode-launches-fixed`` through
   ``ServeRuntime(attn_backend="flash")`` over the reference's ragged
   trace (9 requests, 3 slots, max_len 32), every decode step exactly
   7·L+1 B1 and L B2; AN3 ``serve/paged-decode-launches-fixed`` and
   ``serve/paged-prefill-group-launches`` through ``PagedServeRuntime``
   (page 4, 14 pages), every step 7·L+1 B1 and L B3, each prefill group
   key one multiset, prefix hits and evictions above 0; AN4
   ``serve/fused-signature-per-site-class``, the launched signatures equal
   to ``hw.fused_site_classes``; AN5 no ``nvcc`` run during AN; AN6 the
   two sweep contracts on the classifier vehicle.  Printed, not gated:
   the synchronizing calls per decode step
   (``torch.cuda.set_sync_debug_mode("warn")`` over AN2's serve) and
   their sites.  AN's launches are added to B1's, B2's and B3's entries;
8. path PD — drift, stuck-cell faults and self-healing on the main path's
   params, requests and calibration tokens, under benchmarks/driftbench.py's
   spec on the kernel route (``PackManager``; ``ServeRuntime(attn_backend=
   "flash")`` and ``PagedServeRuntime(backend="kernel")`` given a manager,
   a ``DriftClock`` and a ``HealPolicy``).  Gates: ``aged(1.0)`` equals the
   fresh pack tensor for tensor, aging at 64 differs and replays; healing
   that changes no value leaves the dense and paged runtimes' tokens as
   they were; a pack reprogrammed at 16 and recalibrated at 64 serves
   ``decode_lm``'s tokens but at near ties; the fused MVM, flash-decode and
   paged-attention kernels launch, and the fused MVM kernel equals its
   plain version at the health probe's 124 rows.  Printed only: the
   healing trace heal-off and heal-on, the seconds spent aging,
   reprogramming, recalibrating and probing, the decode step on the healed
   pack and the peak device memory;
9. path SW — the design-space sweep engine (``repro_torch.sweep``) on the
   main path's params and calibration tokens, with 4 x 32 eval tokens
   from the same generator and their first 8 tokens as prompts:
   ``run_sweep`` through one ``ServeEvaluator`` over G1 (lm_accuracy's
   scheme axis x alpha {0.02, 0.05}, Design A with ``fused="kernel"``, the
   fused MVM kernel on its differential points) and G2 (lm_parasitics'
   ``r_hat`` axis {1e-4, 1e-3} on the ``use_pallas`` route: the bit-line
   kernel in calibration, the legacy parasitic kernel in serving), one
   trial each.  Gates: every point equals ``serve_serial_reference``; G1
   rerun from its cache comes back all cached and equal, and G2 is one
   compile group; a G1 point with the fused MVM kernel swapped for its
   plain version gives equal metrics; the three kernels launch.  Printed:
   each point's metrics and seconds by phase, the digital loss, SW's
   seconds and peak device memory.  SW's launches are added to those
   three kernels' entries of the kernel list;
10. path RW — rwkv6-3b, the attention-free family, at its published
    width (d 2560, 40 heads of 64, d_ff 8960, vocab 65536, bfloat16),
    weights from a seed, depth cut to ``--layers``: its eight projections
    a layer and its head programmed with the main path's Design A
    (``fused="kernel"``), calibrated on 4 x 32 tokens, and serving 4
    prompts of 16 tokens, 8 new each, through ``decode_lm``.  Gates: RW1
    the tokens and the prefill logits equal the same pack's on B1's plain
    version; RW2 prefill then one ``decode_step`` matches the forward over
    S + 1 tokens under ``tests/test_arch_smoke.py``'s tolerance (float32;
    bfloat16 printed); RW3 the chunked recurrence within the reference's
    bound of the step-by-step one at the full-width shapes, both modes;
    RW4 B1 launched, and equal to its plain version at the ``ck`` and
    ``cv`` sites and the head, M = 4 and 128.  Printed: the decode step,
    calibration seconds and peak memory;
11. phase FAM — the other families at published width: qwen3-moe (1
    layer), internvl2 (2 layers, 256 patch embeddings), zamba2 (6 layers)
    and whisper (2 + 2 layers, 1500 frames) hold prefill/decode against
    the forward as RW2 does; qwen3-moe, internvl2 and arctic-480b (its
    smoke config: one layer of experts is 53.5 GB in float32) serve 4
    prompts through ``decode_lm`` on B1 with the plain route's tokens;
    an MoE forward twice gives equal logits.  RW's and FAM's B1 launches
    are added to B1's entry of the kernel list;
12. path TR — training: qwen1.5-4b at published width, depth cut to
    ``--layers``, bf16 activations over fp32 master parameters, remat on,
    ``SHAPES["train_4k"]``'s 4096 positions with the global batch cut from
    256 to 2 in 2 microbatches, AdamW (``cosine_schedule(3e-4, 2, 8)``,
    clip 1.0, weight decay 0.1) on ``SyntheticLM`` batches, every step
    through ``resilient_step`` and a ``StragglerMonitor``.  Gates: TR1
    four steps with finite losses and grad norms, a fifth on step 4's
    batch lower; TR2 microbatches 2 against 1 within 1e-4 relative (float32,
    1 layer); TR3 remat on against off, every leaf equal (the embedding's
    within 1e-5 of its largest magnitude); TR4 ``save_async`` of the whole
    state beside the next step and ``restore`` onto the card, every leaf
    equal and the data replayed; TR5 no kernel launched and no JAX loaded.
    Printed: step time, tokens/s, the AdamW update alone, peak memory, the
    checkpoint's GB and seconds.  TR reaches no kernel of ``csrc/``;
13. path SO — scale-out on one card: the sharded steps of
    ``repro_torch.launch.steps`` on a one-rank NCCL group
    (``dist.HashStore``, no port) and a (1, 1) ``("data", "model")``
    DeviceMesh, qwen1.5-4b at published width and TR's depth, weights from
    seed 0, held against the unsharded path.  Gates: SO0 the group and
    mesh open and close; SO1 ``build_train_step`` over TR's two
    microbatches of 2 x 4096 tokens, two steps, against
    ``train_step_fn`` from the same seed (its state moved to the host
    first): loss, grad norm, lr and every parameter and moment
    ``torch.equal``; SO2 ``build_prefill`` (4 rows x 32 positions) and 8
    greedy ``build_decode`` steps against ``prefill``/``decode_step``:
    logits every step and the caches ``torch.equal``; SO3 every returned
    placement equals ``to_placements`` of the rules' spec, no kernel of
    ``csrc/`` launched and no JAX loaded.  Printed: the sharded and
    unsharded step times, peak memory, and the per-device GB of TR's whole
    40-layer state on the (8,1), (2,4) and (16,16) meshes from the rules'
    shard shapes.  One card cannot show what exists only across ranks:
    multi-rank numerics are held on a gloo mesh on the CPU
    (``tests/test_torch_distribution.py``);
14. phase DR — the dry-run tooling (``repro_torch.launch.dryrun``,
    ``op_stats``, ``roofline``), which touches no device: its CPU halves
    start before path TR, each in its own ``python3`` process with no
    card visible (a fake process group cannot share a process with SO's
    NCCL group).  Gates: DR1 qwen1.5-4b x train_4k and x decode_32k and
    rwkv6-3b x prefill_32k at full width and depth on the 16 x 16 fake
    pod, and qwen1.5-4b x decode_32k on the 512-rank 2 x 16 x 16 two
    pods, no error or skip, 256 or 512 devices, the arguments' bytes
    equal to the rules' local shards, and 0.05 < useful_ratio <= 1; DR2 the dry-run of TR's reduced cell on a
    1 x 1 fake mesh against the same ``build_train_step`` on a one-rank
    NCCL group on the card, both counted by ``OpStats``: flops equal, HBM
    bytes within 1%, the arguments' bytes equal, and the H100 roofline
    bound no longer than the measured step; DR3 qwen3-moe-235b-a22b x
    prefill_32k at full width, 1 layer, on the 16 x 16 fake pod, counted
    in its own process (the card visible) on a ``cuda`` mesh, DTensor's
    NCCL branch, and on the dry-run's ``cpu`` mesh with its all-to-all
    hook: flops, collective bytes and counts equal kind by kind,
    all-to-alls on both, and both within 5% of the CPU build's count
    (``DR3_COLL``); DR4 the 30 smoke cells of ``tests/test_torch_
    dryrun.py`` on its (2, 4) fake mesh and the 10 train cells on 1 x 1,
    counted on the card's own torch in one process with no card visible,
    started right after the build: every cell counts, each train cell's
    flops x 8 equal its 1 x 1 flops, every cell's flops equal the CPU
    build's (``DR4_HERE``), the MoE train and prefill cells count an
    all-to-all, and no cell's collective bytes exceed 1.05x the CPU
    build's; DR4v zamba2-7b's, whisper-large-v3's and arctic-480b's
    sharded train (2 microbatches), prefill and decode steps on a (2, 2)
    gloo mesh of 4 CPU processes against the unsharded steps, within the
    bounds of ``tests/test_torch_distribution.py`` (its job bodies,
    ``repro_torch.launch.gloo_jobs``), started beside DR4.  Printed:
    seconds per cell, DR1's per-device collective bytes and counts and
    roofline terms, DR2's roofline fraction and the dry-run's peak
    estimate beside ``max_memory_allocated``, DR3's two records, one
    line a DR4 cell beside the CPU build's count, DR4v's largest
    differences;
15. phase EX — the port's entry points, the six examples of
    ``repro_torch.examples`` (counterparts of ``examples/*.py``), each
    ``main`` run on the card at the reference's sizes, steps and seeds'
    roles, its lines printed under its name.  Gates: quickstart's Design A
    relative error below Design E's, both finite; hetero_profile's head
    digital (``pack.head is None``) and one energy row per site of its
    pack; analog_serve's digital loss, three designs' analog losses and
    the agreement finite; serve_loop's 10 completions, ``tokens_out`` the
    sum of their lengths; design_space's digital accuracy and five
    designs' accuracies, energies and areas finite; train_lm's ~100M LM
    (8 x 768, vocab 32000, fp32) 300 steps of 16 x 128 tokens, the last
    loss below the first, checkpoints 200 and 300 kept under
    ``build/ex/train_lm``, and a second invocation on that directory
    printing ``resumed from step 300`` and taking no step.  The examples
    keep the reference's ``fused="off"`` and ``attn_backend="stream"``:
    they reach none of the kernels, and ``kernels.fused.LAUNCHES`` is
    printed after each, so that a change of route shows.  Printed:
    seconds per example, train_lm's median step, tokens/s and peak memory
    (beside what earlier phases still held on the card when it started).

Each path sets every launch count to 0 just before it and reads them just
after.  The line before the last lists every ported kernel as JSON (the
attention kernels' entries also carry their per-call numbers at both
timed shapes under ``shapes``); the
last line is ``{"ok": true, "device": {...}}``.  The script exits non-zero,
printing no result, when there is no CUDA device or no checkout around
it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: published peaks of one H100 SXM (dense, NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: fp32 operations a bound counts for one IEEE division (``__fdiv_rn``):
#: not one flop but a reciprocal on the special-function unit refined by
#: fused multiply-adds on the fp32 pipe.  The SFU issues 16 reciprocals per
#: clock per SM against 128 fp32 lanes, so a division's reciprocal alone
#: holds the issue time of 8 lanes' FMAs, 16 flops at the 67 TFLOP/s rate;
#: the refinement's FMAs, which run beside it on the fp32 pipe, are not
#: counted, so the bound stays a lower one.
DIV_FLOPS = 16

SEED = 0
DEVICE = "cuda"
MAX_LEN = 32          # the served cache length (and the prefill bucket)
FUSED_REPLACES = "src/repro/kernels/fused.py:258"      # fused_mvm_pallas
FLASH_REPLACES = "src/repro/kernels/fused.py:364"      # flash_attention_pallas
# fused_mvm_parasitic_pallas, bitline_mvm_pallas, analog_bitline_diff_pallas,
# analog_mvm_diff_pallas
PARASITIC_REPLACES = "src/repro/kernels/fused.py:282"
BITLINE_REPLACES = "src/repro/kernels/bitline.py:90"
BL_DIFF_REPLACES = "src/repro/kernels/bitline.py:159"
MVM_DIFF_REPLACES = "src/repro/kernels/analog_mvm.py:123"
PAGED_REPLACES = "src/repro/kernels/paged.py:111"   # paged_attention_pallas
# analog_mvm_bitserial_pallas
BITSERIAL_REPLACES = "src/repro/kernels/analog_mvm.py:141"
R_HAT = 1e-4          # the middle of the paper's Fig. 19 axis
PAGE_SIZE = 8         # path PG's page (max_len 32 = 4 pages per slot)
PD_SEED = 7           # path PD's programming seed (the main path's)
PD_HEAL_AT, PD_AGE = 16.0, 64.0   # PD's reprogram age and served age
PD_HORIZON = 256.0    # the healing trace's final age (driftbench's)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time(fn, reps: int = 10, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's work per call (a wrapper's checks and casts, ``ctypes``) is not
    timed.  ``fn``'s operands must already lie on the card."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound_ms(n_bytes: float, n_flops: float):
    """Least time for the work: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_fused_grid(torch, ops, tol) -> dict:
    """The fused kernel against its plain version on the CPU test grid."""
    worst = {"flips": 0, "max_abs_err": 0.0, "max_ulp": 0.0}
    for (m, p, s, rows, n, nb, cb) in tol.FUSED_GRID:
        t = [torch.as_tensor(a, device=DEVICE)
             for a in tol.fused_case(m, p, s, rows, n)]
        kw = dict(adc_lo=t[3], adc_hi=t[4], adc_bits=8, cell_bits=cb,
                  n_bits=nb, scale=torch.tensor(3e-4, device=DEVICE))
        y = ops.fused_mvm(*t[:3], backend="kernel", **kw)
        y_ref = ops.fused_mvm(*t[:3], backend="oracle", **kw)
        torch.cuda.synchronize()
        r = tol.fused_mvm_check(y, y_ref, *t, kw["scale"], adc_bits=8,
                                cell_bits=cb, n_bits=nb)
        if not r["ok"]:
            raise AssertionError(f"fused_mvm grid case {(m, p, s, rows, n, nb)}"
                                 f" outside the bound: {r}")
        worst["flips"] += r["flips"]
        worst["max_abs_err"] = max(worst["max_abs_err"], r["max_abs_err"])
        worst["max_ulp"] = max(worst["max_ulp"], r["max_ulp"])
    return worst


def full_width_site(torch, A, E, k: int, n: int, ms, seed: int):
    """Design-A conductances of a random (k, n) weight and, for each row
    count in ``ms``, quantized activations with ADC ranges from the plain
    version's pre-ADC values."""
    from repro_torch.core.adc import range_from_samples
    from repro_torch.core.quant import quantize_acts
    from repro_torch.kernels.ref import fused_pre_adc

    spec = A.design_a(error=E.state_proportional(0.05))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device=DEVICE) * k ** -0.5
    aw = A.program(w, spec, seed=seed)
    p, rows = spec.n_partitions(k), spec.rows_per_partition(k)
    m_ = spec.mapping
    inputs = []
    for m in ms:
        x = torch.randn((m, k), generator=gen, device=DEVICE)
        xq = quantize_acts(x, spec.input_bits)
        x_parts = torch.nn.functional.pad(xq.values, (0, p * rows - k)) \
            .reshape(m, p, rows).contiguous()
        lo, hi = range_from_samples(
            fused_pre_adc(x_parts, aw.g_pos, aw.g_neg, None))
        scale = (m_.levels_per_cell - 1) / (1.0 - m_.g_min) * aw.w_scale \
            * xq.scale
        inputs.append((x_parts, lo.reshape(1), hi.reshape(1), scale))
    return aw.g_pos, aw.g_neg, inputs


def fused_full_width(torch, A, E, ops, tol, cfg, n_layers: int,
                     prefill_m: int) -> dict:
    """The decode shapes of one qwen1.5-4b step (M = 4 rows), and the same
    sites at a full prefill bucket (M = ``prefill_m`` rows): each call
    equal to its plain version to the bit and within the bound, timed on
    the device alone (a CUDA graph of ten launches) beside the wrapper's
    time per call (CUDA events around ten calls, host work included)."""
    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.vocab
    shapes = [("wq", d, cfg.n_heads * cfg.hd, 4 * n_layers),
              ("w_gate", d, ff, 2 * n_layers),
              ("w_down", ff, d, n_layers),
              ("head", d, vocab, 1)]
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "wrapper_ms": 0.0,
           "max_abs_err": 0.0, "flips": 0, "bytes": 0, "flops": 0}

    def check(name, x, gp, gm, kw):
        y = ops.fused_mvm(x, gp, gm, backend="kernel", **kw)
        y_ref = ops.fused_mvm(x, gp, gm, backend="oracle", **kw)
        torch.cuda.synchronize()
        r = tol.fused_mvm_check(y, y_ref, x, gp, gm, kw["adc_lo"],
                                kw["adc_hi"], kw["scale"], adc_bits=8,
                                cell_bits=7, n_bits=None)
        if not r["ok"] or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"fused_mvm {name} M={x.shape[0]} outside "
                                 f"the bound: {r}")
        if not torch.equal(y, y_ref):
            raise AssertionError(f"fused_mvm {name} M={x.shape[0]} is not "
                                 f"its plain version to the bit")
        return r

    for i, (name, k, n, per_step) in enumerate(shapes):
        gp, gm, inputs = full_width_site(torch, A, E, k, n, (4, prefill_m),
                                         SEED + 100 + i)
        lines = []
        for j, (x, lo, hi, scale) in enumerate(inputs):
            kw = dict(adc_lo=lo, adc_hi=hi, adc_bits=8, cell_bits=7,
                      n_bits=None, scale=scale)
            r = check(name, x, gp, gm, kw)

            def call():
                return ops.fused_mvm(x, gp, gm, backend="kernel", **kw)

            ms = graph_time(call)
            wrapper = cuda_time(call, reps=10)
            m, p, rows = x.shape
            n_bytes = 4 * (x.numel() + gp.numel() + gm.numel() + 3 + m * n)
            n_flops = 2 * m * p * rows * n + p * rows * n
            b_ms, b_by = bound_ms(n_bytes, n_flops)
            tot["max_abs_err"] = max(tot["max_abs_err"], r["max_abs_err"])
            tot["flips"] += r["flips"]
            if j:      # the prefill bucket: kernel time against its bound
                lines.append(f"prefill M={m}: kernel {ms:.4f} ms (device; "
                             f"wrapper {wrapper:.4f} ms)  bound {b_ms:.4f} ms "
                             f"({b_by})  max_abs_err {r['max_abs_err']:.3e}  "
                             f"flips {r['flips']}  equal to plain")
                continue
            plain = cuda_time(lambda: ops.fused_mvm(
                x, gp, gm, backend="oracle", **kw), reps=3, warmup=1)
            xp, g0 = x.permute(1, 0, 2).contiguous(), gp[0]
            lib = graph_time(lambda: torch.matmul(xp, g0))
            lines.append(f"M={m} P={p} rows={rows} N={n} x{per_step}/step  "
                         f"kernel {ms:.4f} ms (device; wrapper {wrapper:.4f} "
                         f"ms)  plain {plain:.4f} ms  bound {b_ms:.4f} ms  "
                         f"torch.matmul(dot only) {lib:.4f} ms  max_abs_err "
                         f"{r['max_abs_err']:.3e}  flips {r['flips']}  equal "
                         f"to plain")
            tot["ms"] += ms * per_step
            tot["wrapper_ms"] += wrapper * per_step
            tot["plain_ms"] += plain * per_step
            tot["bytes"] += n_bytes * per_step
            tot["flops"] += n_flops * per_step
            tot["library_ms"] += lib * per_step
        print(f"fused_mvm {name}: " + "; ".join(lines), flush=True)
        del gp, gm, inputs
        torch.cuda.empty_cache()
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["flops"])
    print(f"fused_mvm per decode step: {tot['ms']:.4f} ms on the device "
          f"(wrapper {tot['wrapper_ms']:.4f} ms), bound {tot['bound_ms']:.4f} "
          f"ms ({tot['bound_by']}), torch.matmul {tot['library_ms']:.4f} ms",
          flush=True)
    return tot


def flash_case(torch, tol, b, s, kv, g, hd, dtype, seed=None):
    """A flash-decode case on the card, K and V in ``dtype``."""
    q, k, v, fills = (torch.as_tensor(a, device=DEVICE)
                      for a in tol.flash_case(b, s, kv, g, hd, seed))
    return q, k.to(dtype), v.to(dtype), fills


def attn_row(torch, name, q, kv_len, kernel, plain, gk, gv, work):
    """Time one decode-attention call on the device alone (a CUDA graph of
    ten launches) beside the wrapper's time per call (events around 50
    calls), its plain version (events around calls), its bound and
    ``scaled_dot_product_attention`` over the cache-dtype view ``gk``,
    ``gv`` (B, S, KV, hd) on the device alone; print one line and return
    the per-call numbers."""
    b, h, hd = q.shape
    kv = gk.shape[2]
    ms = graph_time(kernel)
    wrapper = cuda_time(kernel, reps=50)
    plain_ms = cuda_time(plain, reps=5, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ks = gk.permute(0, 2, 1, 3).contiguous()
    vs = gv.permute(0, 2, 1, 3).contiguous()
    qs = q[:, :, None, :].to(ks.dtype)
    mask = (torch.arange(ks.shape[2], device=DEVICE)[None, :]
            < kv_len[:, None])[:, None, None, :]
    if kv != h:
        ks, vs = (t.repeat_interleave(h // kv, dim=1) for t in (ks, vs))
    lib = graph_time(lambda: sdpa(qs, ks, vs, attn_mask=mask))
    b_ms, b_by = bound_ms(*work)
    print(f"{name}: B={b} H={h} KV={kv} hd={hd} S={gk.shape[1]} "
          f"{str(gk.dtype).split('.')[-1]} fills={kv_len.tolist()}  kernel "
          f"{ms:.4f} ms (device; wrapper {wrapper:.4f} ms)  plain "
          f"{plain_ms:.4f} ms  bound {b_ms:.5f} "
          f"ms ({b_by})  sdpa {lib:.4f} ms (device, {str(ks.dtype).split('.')[-1]}"
          f" view)", flush=True)
    return {"ms": ms, "wrapper_ms": wrapper, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def flash_work(q, k, kv_len):
    """(bytes, operations) of one flash-decode call: q, the valid
    positions' K and V, the fills read once, the float32 output written
    once; 4 hd + 4 operations per (position, query head)."""
    b, h, hd = q.shape
    valid = int(kv_len.sum())
    kv = k.shape[2]
    return ((4 * q.numel() + 2 * valid * kv * hd * k.element_size()
             + 4 * b + 4 * b * h * hd), valid * h * (4 * hd + 4))


def per_step(row: dict, n_layers: int) -> dict:
    """A per-call timing row as the kernels line's per-decode-step entry."""
    step = {key: row[key] * n_layers
            for key in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                        "library_ms")}
    step["bound_by"] = row["bound_by"]
    return step


def flash_checks(torch, ops, tol, cfg, n_layers: int, max_len: int,
                 cache_dtype) -> dict:
    """The flash-decode kernel: against its plain version on the CPU test
    grid, at the served shape (4 rows, ``max_len`` positions) and at 4 rows
    x 2048 positions, each timed on the device beside its plain version,
    its bound and ``scaled_dot_product_attention`` over the cache."""
    worst = 0.0
    for (b, s, kv, g, hd) in tol.FLASH_GRID:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, fills = flash_case(torch, tol, b, s, kv, g, hd, dt)
            out = ops.flash_attention_decode(q, k, v, fills, backend="kernel")
            ref = ops.flash_attention_decode(q, k, v, fills, backend="oracle")
            r = tol.flash_decode_check(out, ref, v, fills)
            if not r["ok"]:
                raise AssertionError(f"flash grid case {(b, s, kv, g, hd, dt)}"
                                     f" outside the bound: {r}")
            worst = max(worst, r["max_abs_err"])

    b, h, kv, hd = 4, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    served = flash_case(torch, tol, b, max_len, kv, h // kv, hd,
                        cache_dtype, SEED + 50)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 51)
    n_long = 2048
    long = (torch.randn((b, h, hd), generator=gen, device=DEVICE),
            torch.randn((b, n_long, kv, hd), generator=gen, device=DEVICE)
            .to(cache_dtype),
            torch.randn((b, n_long, kv, hd), generator=gen, device=DEVICE)
            .to(cache_dtype),
            torch.full((b,), n_long, dtype=torch.int32, device=DEVICE))
    rows = {}
    for name, (q, k, v, fills) in (("served", served), ("4x2048", long)):
        out = ops.flash_attention_decode(q, k, v, fills, backend="kernel")
        ref = ops.flash_attention_decode(q, k, v, fills, backend="oracle")
        r = tol.flash_decode_check(out, ref, v, fills)
        if not r["ok"] or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"flash_decode at {name}: {r}")
        worst = max(worst, r["max_abs_err"])
        rows[name] = attn_row(
            torch, f"flash_decode {name}", q, fills,
            lambda: ops.flash_attention_decode(q, k, v, fills,
                                               backend="kernel"),
            lambda: ops.flash_attention_decode(q, k, v, fills,
                                               backend="oracle"),
            k, v, flash_work(q, k, fills))
    print(f"flash_decode: {len(tol.FLASH_GRID)} grid cases in float32 and "
          f"bfloat16, the served shape and 4 x 2048 positions within the "
          f"bound; max_abs_err {worst:.3e}; x{n_layers} per decode step",
          flush=True)
    return {**per_step(rows["served"], n_layers), "max_abs_err": worst,
            "shapes": rows}


def check_attn_edge_grid(torch, ops, tol) -> float:
    """Both decode-attention kernels on ``tolerance.ATTN_EDGE_GRID`` (the
    edges of their split of positions over a cluster, 2048 to 32768
    positions): each within the bound of its plain version and within the
    float64 bound of ``tolerance.attention_f64_check``, the paged kernel
    equal to the flash-decode kernel on the gathered view."""
    worst = 0.0
    for case in tol.ATTN_EDGE_GRID:
        q, k, v, lens, kp, vp, ptab = tol.attn_edge_case(*case, device=DEVICE)
        flash = ops.flash_attention_decode(q, k, v, lens)
        paged = ops.paged_attention(q, kp, vp, ptab, lens)
        b, npg = ptab.shape
        view = [p[ptab.long()].reshape(b, npg * p.shape[1], *p.shape[2:])
                .contiguous() for p in (kp, vp)]
        on_view = ops.flash_attention_decode(q, *view, lens)
        r1 = tol.flash_decode_check(flash, ops.flash_attention_decode(
            q, k, v, lens, backend="oracle"), v, lens)
        r2 = tol.paged_attention_check(paged, ops.paged_attention(
            q, kp, vp, ptab, lens, backend="oracle"), vp, ptab, lens)
        r3, r4 = (tol.attention_f64_check(out, q, k, v, lens)
                  for out in (flash, paged))
        if not all(r["ok"] for r in (r1, r2, r3, r4)):
            raise AssertionError(f"attention edge case {case} outside the "
                                 f"bound: {r1} {r2}; float64: {r3} {r4}")
        if not torch.equal(paged, on_view):
            raise AssertionError(f"attention edge case {case}: paged != "
                                 f"flash_decode on the gathered view")
        worst = max(worst, r1["max_abs_err"], r2["max_abs_err"])
        del q, k, v, kp, vp, view
        torch.cuda.empty_cache()
    return worst


def check_parasitic_grids(torch, ops, tol) -> dict:
    """The four parasitic/legacy kernels against their plain versions on the
    CPU test grids; returns each kernel's largest error."""
    worst = {"fused_mvm_parasitic": 0.0, "bitline_mvm": 0.0,
             "analog_bitline_diff": 0.0, "analog_mvm_diff": 0.0}

    def hold(name, case, r):
        if not r["ok"]:
            raise AssertionError(f"{name} grid case {case} outside the "
                                 f"bound: {r}")
        worst[name] = max(worst[name], r["max_abs_err"])

    def on(*arrays):
        return [torch.as_tensor(a, device=DEVICE) for a in arrays]

    for case in tol.FUSED_PARASITIC_GRID:
        m, p, s, rows, n, r_hat = case
        x, gp, gm, lo, hi = on(*tol.fused_parasitic_case(m, p, s, rows, n))
        kw = dict(r_hat=r_hat, adc_lo=lo, adc_hi=hi, adc_bits=8,
                  cell_bits=2 if s > 1 else 7, n_bits=7,
                  scale=torch.tensor(3e-4, device=DEVICE))
        y = ops.fused_mvm_parasitic(x, gp, gm, **kw)
        y_ref = ops.fused_mvm_parasitic(x, gp, gm, backend="oracle", **kw)
        hold("fused_mvm_parasitic", case, tol.fused_mvm_parasitic_check(
            y, y_ref, x, gp, gm, r_hat, lo, hi, kw["scale"], adc_bits=8,
            cell_bits=kw["cell_bits"], n_bits=7))
        if not torch.equal(y, y_ref):
            raise AssertionError(f"fused_mvm_parasitic grid case {case} is "
                                 f"not its plain version to the bit")
    for case in tol.BITLINE_GRID:
        m, k, n, r_hat = case
        x, g = on(*tol.bitline_case(m, k, n))
        y = ops.bitline_mvm(g, x, r_hat)
        y_ref = ops.bitline_mvm(g, x, r_hat, backend="oracle")
        hold("bitline_mvm", case, tol.bitline_check(y, y_ref))
        if not torch.equal(y, y_ref):
            raise AssertionError(f"bitline_mvm grid case {case} is not its "
                                 f"plain version to the bit")
    lo, hi = (torch.tensor(v, device=DEVICE) for v in tol.LEGACY_RANGE)
    for case in tol.LEGACY_PARASITIC_GRID:
        x, gp, gm = on(*tol.legacy_case(*case))
        kw = dict(r_hat=1e-3, n_bits=7, adc_lo=lo, adc_hi=hi, adc_bits=8,
                  gain=tol.LEGACY_GAIN)
        y = ops.analog_mvm_parasitic(x, gp, gm, **kw)
        y_ref = ops.analog_mvm_parasitic(x, gp, gm, backend="oracle", **kw)
        hold("analog_bitline_diff", case, tol.analog_mvm_check(
            y, y_ref, x, gp, gm, lo, hi, tol.LEGACY_GAIN, adc_bits=8,
            r_hat=1e-3, n_bits=7))
        if not torch.equal(y, y_ref):
            raise AssertionError(f"analog_bitline_diff grid case {case} is "
                                 f"not its plain version to the bit")
    for case in tol.LEGACY_GRID:
        m, p, rows, n, adc_bits = case
        x, gp, gm = on(*tol.legacy_case(m, p, rows, n, seed=m * 7 + p))
        kw = dict(adc_lo=lo, adc_hi=hi, adc_bits=adc_bits,
                  gain=tol.LEGACY_GAIN)
        hold("analog_mvm_diff", case, tol.analog_mvm_check(
            ops.analog_mvm(x, gp, gm, **kw),
            ops.analog_mvm(x, gp, gm, backend="oracle", **kw),
            x, gp, gm, lo, hi, tol.LEGACY_GAIN, adc_bits=adc_bits))
    torch.cuda.synchronize()
    return worst


def sweep_ops(systems: int, rows: int):
    """fp32 operations of ``systems`` Thomas sweeps of ``rows`` rows: per
    row two exact products, three adds, one g * r product and two
    divisions; per system the final division by r."""
    return systems * (rows * (6 + 2 * DIV_FLOPS) + DIV_FLOPS)


def parasitic_calls(ops, tol, x, gp, gm, lo, hi, scale, gain, nb: int,
                    r_hat=R_HAT):
    """The fused parasitic and legacy parasitic Design-A kernels on one
    site's operands (Design A at ``r_hat``, ``nb`` input bits), each as
    (call, check, bytes, operations): ``call(backend)`` runs it,
    ``check(y, y_plain)`` holds it to the bound, and the bytes and fp32
    operations are its bound's work."""
    m, p, rows = x.shape
    n = gp.shape[-1]
    n_bytes = 4 * (x.numel() + gp.numel() + gm.numel() + m * n)
    n_flops = sweep_ops(2 * nb * m * p * n, rows) + 3 * nb * m * p * n
    return {
        "fused_mvm_parasitic": (
            lambda b: ops.fused_mvm_parasitic(
                x, gp, gm, r_hat=r_hat, adc_lo=lo, adc_hi=hi, adc_bits=8,
                cell_bits=7, n_bits=nb, scale=scale, backend=b),
            lambda y, yr: tol.fused_mvm_parasitic_check(
                y, yr, x, gp, gm, r_hat, lo, hi, scale, adc_bits=8,
                cell_bits=7, n_bits=nb),
            n_bytes, n_flops),
        "analog_bitline_diff": (
            lambda b: ops.analog_mvm_parasitic(
                x, gp, gm, r_hat=r_hat, n_bits=nb, adc_lo=lo, adc_hi=hi,
                adc_bits=8, gain=gain, backend=b),
            lambda y, yr: tol.analog_mvm_check(
                y, yr, x, gp[0], gm[0], lo, hi, gain, adc_bits=8,
                r_hat=r_hat, n_bits=nb),
            n_bytes, n_flops),
    }


def hold_equal(torch, label: str, call, check):
    """Run ``call`` (a kernel's wrapper, by backend) on the card and as its
    plain version, and raise unless the card's output is finite, within
    ``check``'s bound and equal to the plain one to the bit.  Returns the
    check's result and the output's shape."""
    y = call("kernel")
    y_ref = call("oracle")
    torch.cuda.synchronize()
    r = check(y, y_ref)
    shape = tuple(y.shape)
    if not r["ok"] or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{label} {shape} outside the bound: {r}")
    if not torch.equal(y, y_ref):
        raise AssertionError(f"{label} {shape} is not its plain version to "
                             f"the bit")
    return r, shape


def parasitic_full_width(torch, A, E, ops, tol, cfg, n_layers: int,
                         prefill_m: int) -> dict:
    """The three serving kernels of paths P1 and P2 at the sites of one
    qwen1.5-4b decode step (M = 4 token rows, Design A): each against its
    plain version, with its time, the plain version's, its bound and, for
    the legacy Design-A kernel, the dot as one torch.matmul.  Times are
    summed over a step's sites (wq's shape 4 per layer, w_gate's 2,
    w_down's 1, the head once).  Each kernel must equal its plain version
    to the bit, here and at a full prefill bucket (M = ``prefill_m``).
    The legacy Design-A kernel is timed on the device alone (a CUDA graph
    of ten launches, as is its torch.matmul) beside the wrapper's time per
    call, the parasitic kernels (milliseconds a call) by events around
    calls.  The bit-line kernel runs only in path P2's calibration and is
    held there, at the shapes that gives it
    (:func:`bitline_at_calibration`)."""
    from repro_torch.core.adc import range_from_samples
    from repro_torch.kernels.ref import fused_pre_adc, parasitic_pre_adc

    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.vocab
    shapes = [("wq", d, cfg.n_heads * cfg.hd, 4 * n_layers),
              ("w_gate", d, ff, 2 * n_layers),
              ("w_down", ff, d, n_layers),
              ("head", d, vocab, 1)]
    names = ("fused_mvm_parasitic", "analog_bitline_diff", "analog_mvm_diff")
    tot = {nm: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0,
                "max_abs_err": 0.0, "flips": 0, "library_ms": None}
           for nm in names}
    tot["analog_mvm_diff"].update(library_ms=0.0, wrapper_ms=0.0)
    spec = A.design_a(error=E.state_proportional(0.05))
    m_ = spec.mapping
    gain = (m_.levels_per_cell - 1) / (1.0 - m_.g_min)
    nb = spec.n_planes
    m = 4
    for i, (site, k, n, per_step) in enumerate(shapes):
        gp, gm, inputs = full_width_site(torch, A, E, k, n, (m, prefill_m),
                                         SEED + 200 + i)
        x, lo_lin, hi_lin, scale = inputs[0]
        p, rows = x.shape[1], x.shape[2]
        lo_par, hi_par = (t.reshape(1) for t in range_from_samples(
            parasitic_pre_adc(x, gp, gm, R_HAT, nb)))
        calls = parasitic_calls(ops, tol, x, gp, gm, lo_par, hi_par, scale,
                                gain, nb)
        calls["analog_mvm_diff"] = (
            lambda b: ops.analog_mvm(
                x, gp, gm, adc_lo=lo_lin, adc_hi=hi_lin, adc_bits=8,
                gain=gain, backend=b),
            lambda y, yr: tol.analog_mvm_check(
                y, yr, x, gp[0], gm[0], lo_lin, hi_lin, gain, adc_bits=8),
            4 * (x.numel() + gp.numel() + gm.numel() + m * n),
            2 * m * p * rows * n + p * rows * n)
        lines = []
        for nm, (call, check, n_bytes, n_flops) in calls.items():
            r, _ = hold_equal(torch, f"{nm} at {site}", call, check)
            legacy = nm == "analog_mvm_diff"
            if legacy:
                ms = graph_time(lambda: call("kernel"))
                wrapper = cuda_time(lambda: call("kernel"), reps=10)
                t_wrap = f" (device; wrapper {wrapper:.4f} ms)"
                tot[nm]["wrapper_ms"] += wrapper * per_step
            else:
                ms = cuda_time(lambda: call("kernel"), reps=5, warmup=1)
                t_wrap = ""
            t0 = time.perf_counter()
            call("oracle")
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t0) * 1e3
            b_ms, b_by = bound_ms(n_bytes, n_flops)
            t = tot[nm]
            t["max_abs_err"] = max(t["max_abs_err"], r["max_abs_err"])
            t["flips"] += r.get("flips", 0)
            t["ms"] += ms * per_step
            t["plain_ms"] += plain * per_step
            t["bytes"] += n_bytes * per_step
            t["flops"] += n_flops * per_step
            lib = "  library: none (no PyTorch call solves a bit line)"
            if legacy:
                xpart, gd = x.permute(1, 0, 2).contiguous(), gp[0] - gm[0]
                lib_ms = graph_time(lambda: torch.matmul(xpart, gd))
                t["library_ms"] += lib_ms * per_step
                lib = f"  torch.matmul(dot only) {lib_ms:.4f} ms"
                del gd
            lines.append(f"{nm} kernel {ms:.4f} ms{t_wrap}  plain "
                         f"{plain:.1f} ms  bound {b_ms:.4f} ms ({b_by}){lib}  "
                         f"max_abs_err {r['max_abs_err']:.3e}  equal to plain")
        lines.append(legacy_prefill(torch, ops, tol, gp[0], gm[0], inputs[1],
                                    gain))
        lines += parasitic_prefill(torch, parasitic_calls(
            ops, tol, inputs[1][0], gp, gm, lo_par, hi_par, inputs[1][3],
            gain, nb))
        print(f"parasitic/legacy {site} (M={m} P={p} rows={rows} N={n} "
              f"x{per_step}/step): " + "; ".join(lines), flush=True)
        del gp, gm, inputs
        torch.cuda.empty_cache()
    for t in tot.values():
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"])
    t = tot["analog_mvm_diff"]
    print(f"analog_mvm_diff per decode step: {t['ms']:.4f} ms on the device "
          f"(wrapper {t['wrapper_ms']:.4f} ms), bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}), torch.matmul {t['library_ms']:.4f} ms",
          flush=True)
    return tot


def legacy_prefill(torch, ops, tol, gp, gm, inputs, gain) -> str:
    """The legacy Design-A kernel at a prefill bucket: equal to its plain
    version to the bit and within the bound, timed on the device alone
    beside the wrapper's time per call."""
    x, lo, hi, _ = inputs
    kw = dict(adc_lo=lo, adc_hi=hi, adc_bits=8, gain=gain)
    r, _ = hold_equal(
        torch, "analog_mvm_diff",
        lambda b: ops.analog_mvm(x, gp, gm, backend=b, **kw),
        lambda y, yr: tol.analog_mvm_check(y, yr, x, gp, gm, lo, hi, gain,
                                           adc_bits=8))
    m, p, rows = x.shape
    ms = graph_time(lambda: ops.analog_mvm(x, gp, gm, **kw))
    wrapper = cuda_time(lambda: ops.analog_mvm(x, gp, gm, **kw), reps=10)
    n = gp.shape[-1]
    b_ms, b_by = bound_ms(4 * (x.numel() + gp.numel() + gm.numel() + 2
                               + m * n), 2 * m * p * rows * n + p * rows * n)
    return (f"analog_mvm_diff prefill M={m}: kernel {ms:.4f} ms (device; "
            f"wrapper {wrapper:.4f} ms)  bound {b_ms:.4f} ms ({b_by})  "
            f"max_abs_err {r['max_abs_err']:.3e}  equal to plain")


def parasitic_prefill(torch, calls) -> list:
    """The fused parasitic and legacy parasitic Design-A kernels at a
    prefill bucket (``calls`` from :func:`parasitic_calls`, on the decode
    rows' ADC ranges): each equal to its plain version to the bit and
    within the bound, with one call's time by events beside the bound."""
    lines = []
    for nm, (call, check, n_bytes, n_flops) in calls.items():
        r, (m, _) = hold_equal(torch, nm, call, check)
        ms = cuda_time(lambda: call("kernel"), reps=1, warmup=0)
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        lines.append(f"{nm} prefill M={m}: kernel {ms:.4f} ms  bound "
                     f"{b_ms:.4f} ms ({b_by})  max_abs_err "
                     f"{r['max_abs_err']:.3e}  equal to plain")
    return lines


def bitline_at_calibration(torch, ops, tol, seen: dict, r_hat) -> dict:
    """The bit-line kernel against its plain version on the inputs path P2's
    calibration gave it: ``seen`` maps each (arrays, plane rows) shape to
    its first call's operands and the calibration's launches at that shape.
    Each is checked once (within the bound and equal to the bit), timed,
    and its times and bound are summed over those launches (one
    calibration)."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0,
           "max_abs_err": 0.0, "library_ms": None}
    for (g, x, n_calls) in seen.values():
        y = ops.bitline_mvm(g, x, r_hat)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_ref = ops.bitline_mvm(g, x, r_hat, backend="oracle")
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        r = tol.bitline_check(y, y_ref)
        finite = bool(torch.isfinite(y).all())
        equal = bool(torch.equal(y, y_ref))
        del y, y_ref
        n_g, k, n = g.shape
        m = x.shape[1]
        if not r["ok"] or not finite:
            raise AssertionError(f"bitline_mvm at g {tuple(g.shape)}, x "
                                 f"{tuple(x.shape)} outside the bound: {r}")
        if not equal:
            raise AssertionError(f"bitline_mvm at g {tuple(g.shape)}, x "
                                 f"{tuple(x.shape)} is not its plain version "
                                 f"to the bit")
        ms = cuda_time(lambda: ops.bitline_mvm(g, x, r_hat), reps=3,
                       warmup=1)
        n_bytes = 4 * (x.numel() + g.numel() + n_g * m * n)
        n_flops = sweep_ops(n_g * m * n, k)
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        print(f"bitline_mvm at calibration: g {tuple(g.shape)} x "
              f"{tuple(x.shape)} x{n_calls}/calibration  kernel {ms:.4f} ms  "
              f"plain {plain:.1f} ms  bound {b_ms:.4f} ms ({b_by})  library: "
              f"none (no PyTorch call solves a bit line)  max_abs_err "
              f"{r['max_abs_err']:.3e}  equal to plain", flush=True)
        tot["max_abs_err"] = max(tot["max_abs_err"], r["max_abs_err"])
        tot["ms"] += ms * n_calls
        tot["plain_ms"] += plain * n_calls
        tot["bytes"] += n_bytes * n_calls
        tot["flops"] += n_flops * n_calls
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["flops"])
    return tot


def paged_work(q, k_pages, ptab, kv_len):
    """(bytes, operations) of one paged-attention call: those of
    :func:`flash_work` and the block table read once."""
    n_bytes, n_ops = flash_work(q, k_pages, kv_len)
    return n_bytes + 4 * ptab.numel(), n_ops


def paged_checks(torch, ops, tol, cfg, n_layers: int) -> dict:
    """The paged-attention kernel: against its plain version on the CPU
    test grid and at the served shape, against the flash-decode kernel on
    the gathered view (bitwise), and timed on the device at the served
    shape (4 rows, bf16 pool, page 8, 4 pages a row) and at 4 rows x 2048
    positions (page 16, a shuffled table), each beside its plain version,
    its bound and ``scaled_dot_product_attention`` over the bf16 gathered
    view."""
    worst = 0.0

    def on_card(case, seed):
        b, h, kv, hd, ps, npg, pool_dtype = case
        q, k, v, ptab, kv_len = (torch.as_tensor(a, device=DEVICE) for a in
                                 tol.paged_case(b, h, kv, hd, ps, npg, seed))
        dt = getattr(torch, pool_dtype)
        return q, k.to(dt), v.to(dt), ptab, kv_len

    def gathered(pool, ptab):
        b, npg = ptab.shape
        _, ps, kv, hd = pool.shape
        return pool[ptab.long()].reshape(b, npg * ps, kv, hd).contiguous()

    def hold(what, q, k, v, ptab, kv_len):
        out = ops.paged_attention(q, k, v, ptab, kv_len)
        ref = ops.paged_attention(q, k, v, ptab, kv_len, backend="oracle")
        flash = ops.flash_attention_decode(q, gathered(k, ptab),
                                           gathered(v, ptab), kv_len)
        torch.cuda.synchronize()
        r = tol.paged_attention_check(out, ref, v, ptab, kv_len)
        if not r["ok"] or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"paged_attention {what} outside the bound: "
                                 f"{r}")
        if not torch.equal(out, flash):
            raise AssertionError(f"paged_attention {what} != flash_decode on "
                                 f"the gathered view")
        return r["max_abs_err"]

    for case in tol.PAGED_GRID:
        worst = max(worst, hold(f"grid case {case}", *on_card(case, 0)))
    b, h, kv, hd = 4, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    served = on_card((b, h, kv, hd, PAGE_SIZE, MAX_LEN // PAGE_SIZE,
                      cfg.dtype), SEED + 60)
    worst = max(worst, hold("at the served shape", *served))

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 61)
    n_long, ps_long = 2048, 16
    npg = n_long // ps_long
    dt = getattr(torch, cfg.dtype)
    pool_shape = (1 + b * npg, ps_long, kv, hd)
    long = (torch.randn((b, h, hd), generator=gen, device=DEVICE),
            torch.randn(pool_shape, generator=gen, device=DEVICE).to(dt),
            torch.randn(pool_shape, generator=gen, device=DEVICE).to(dt),
            (1 + torch.randperm(b * npg, generator=gen, device=DEVICE))
            .reshape(b, npg).to(torch.int32),
            torch.full((b,), n_long, dtype=torch.int32, device=DEVICE))
    worst = max(worst, hold("at 4 x 2048 positions", *long))

    rows = {}
    for name, (q, k, v, ptab, kv_len) in (("served", served),
                                          ("4x2048", long)):
        rows[name] = attn_row(
            torch, f"paged_attention {name} (page {k.shape[1]}, NP "
            f"{ptab.shape[1]})", q, kv_len,
            lambda: ops.paged_attention(q, k, v, ptab, kv_len),
            lambda: ops.paged_attention(q, k, v, ptab, kv_len,
                                        backend="oracle"),
            gathered(k, ptab), gathered(v, ptab),
            paged_work(q, k, ptab, kv_len))
    print(f"paged_attention: {len(tol.PAGED_GRID)} grid cases, the served "
          f"shape and 4 x 2048 positions within the bound and equal to "
          f"flash_decode on the gathered view; max_abs_err {worst:.3e}; "
          f"x{n_layers} per decode step", flush=True)
    return {**per_step(rows["served"], n_layers), "max_abs_err": worst,
            "shapes": rows}


def check_bitserial_grid(torch, ops, tol) -> float:
    """The bit-serial kernel against its plain version on the CPU test
    grid, within the bound and to the bit; returns the largest error."""
    worst = 0.0
    lo, hi = (torch.tensor(v, device=DEVICE) for v in tol.BITSERIAL_RANGE)
    for case in tol.BITSERIAL_GRID:
        m, p, rows, n, nb = case
        x, gp, gm = (torch.as_tensor(a, device=DEVICE)
                     for a in tol.bitserial_case(m, p, rows, n, nb))
        kw = dict(n_bits=nb, adc_lo=lo, adc_hi=hi, adc_bits=8,
                  gain=tol.BITSERIAL_GAIN)
        y = ops.analog_mvm_bitserial(x, gp, gm, **kw)
        y_ref = ops.analog_mvm_bitserial(x, gp, gm, backend="oracle", **kw)
        r = tol.bitserial_check(y, y_ref, x, gp, gm, lo, hi,
                                tol.BITSERIAL_GAIN, adc_bits=8, n_bits=nb)
        if not r["ok"] or not torch.equal(y, y_ref):
            raise AssertionError(f"analog_mvm_bitserial grid case {case} "
                                 f"outside the bound or not its plain "
                                 f"version to the bit: {r}")
        worst = max(worst, r["max_abs_err"])
    torch.cuda.synchronize()
    return worst


# ---------------------------------------------------------------------------
# phase AN: the static analyzer and its contracts
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def counting_syncs(caught: list, by_method):
    """Count the warnings ``caught`` gains inside each of ``ServeRuntime``'s
    ``_run_decode``, ``_collect`` and ``_prefill_group`` (by method name)."""
    from repro_torch.serve import ServeRuntime

    saved = {}

    def counted(name, fn):
        def wrapper(self, *a, **kw):
            n0 = len(caught)
            try:
                return fn(self, *a, **kw)
            finally:
                by_method[name] += len(caught) - n0
        return wrapper

    for name in ("_run_decode", "_collect", "_prefill_group"):
        saved[name] = ServeRuntime.__dict__[name]
        setattr(ServeRuntime, name, counted(name, saved[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ServeRuntime, name, fn)


def phase_an(torch, cfg, params, pack, kern_fused) -> dict:
    """Phase AN (module docstring, 7a): the lint, the static contracts and
    the launch contracts on the main path's full-width pack.  Returns the
    launches of AN's serves by kernel."""
    import collections
    import warnings

    from repro_torch.analysis import (analyze_paths, check_contract,
                                      check_contracts, render, rule_ids)
    from repro_torch.analysis import repo_contracts as R
    from repro_torch.analysis.contracts import compile_counter
    from repro_torch.hw import fused_site_classes
    from repro_torch.serve.analog_engine import lm_hook_names

    t_an = time.perf_counter()
    layers = cfg.n_layers
    vehicle = (cfg, params, pack)
    with compile_counter() as builds:
        t = time.perf_counter()
        findings = analyze_paths([str(ROOT / "src" / "repro_torch")])
        n_py = sum(1 for _ in (ROOT / "src" / "repro_torch").rglob("*.py"))
        n_cu = sum(1 for _ in (ROOT / "src" / "repro_torch").rglob("*.cu*"))
        statics = R.static_contracts()
        findings += check_contracts(statics, "static")
        per_rule = collections.Counter(f.rule for f in findings)
        per_rule = {r: per_rule[r] for r in rule_ids() + ["compile-contract"]}
        print(f"AN1 lint of src/repro_torch ({n_py} Python files, {n_cu} "
              f"CUDA sources) and {len(statics)} static contracts: "
              f"{len(findings)} findings {per_rule} in "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        if findings:
            raise AssertionError("AN1: the analyzer is not clean:\n"
                                 + render(findings))

        want = {"fused_mvm": 7 * layers + 1, "flash_decode": layers}
        expect = R.expected_step_launches(cfg, pack, "flash_decode")
        if expect != want:
            raise AssertionError(f"AN2: the pack predicts {expect} launches "
                                 f"a step, not {want}")
        kern_fused.reset_launch_counts()
        t = time.perf_counter()
        by_method = collections.Counter()
        with warnings.catch_warnings(record=True) as caught, \
                counting_syncs(caught, by_method):
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rt, rec, built = R.serve_dense(vehicle)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        dense_s = time.perf_counter() - t
        launches = dict(kern_fused.LAUNCHES)
        steps = len(rec.decode)
        syncs = collections.Counter(
            f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message))
        n_sync = sum(syncs.values())
        print(f"AN2 serve/decode-launches-fixed: {steps} decode steps and "
              f"{sum(map(len, rec.prefill.values()))} prefills over 9 "
              f"requests in {dense_s:.2f} s; every step {rec.decode[0]} "
              f"(expected {want}); prefill groups {sorted(rec.prefill)}; "
              f"synchronizing calls {n_sync} ({n_sync / max(steps, 1):.2f} "
              f"per decode step): {by_method['_run_decode']} inside the "
              f"decode steps, {by_method['_collect']} in _collect, "
              f"{by_method['_prefill_group']} in prefills; sites "
              f"{dict(syncs)}", flush=True)
        bad = rec.decode_violations("AN2", want) \
            + rec.prefill_violations("AN2")
        if bad:
            raise AssertionError("; ".join(bad))

        expected_sigs = set(fused_site_classes(
            pack.profile, lm_hook_names(cfg), layers))
        print(f"AN4 serve/fused-signature-per-site-class: launched "
              f"{sorted(built, key=repr)}, hw.fused_site_classes "
              f"{sorted(expected_sigs, key=repr)}", flush=True)
        if built != expected_sigs or not built:
            raise AssertionError("AN4: launched signatures differ from "
                                 "fused_site_classes")

        before = dict(kern_fused.LAUNCHES)
        t = time.perf_counter()
        prt, prec = R.serve_paged(vehicle)
        torch.cuda.synchronize()
        paged_s = time.perf_counter() - t
        for k, v in kern_fused.LAUNCHES.items():
            launches[k] += v - before[k]
        pwant = {"fused_mvm": 7 * layers + 1, "paged_attention": layers}
        st = prt.stats
        print(f"AN3 serve/paged-decode-launches-fixed and "
              f"serve/paged-prefill-group-launches: {len(prec.decode)} "
              f"decode steps in {paged_s:.2f} s, every step "
              f"{prec.decode[0]} (expected {pwant}); prefill groups "
              f"{ {k: len(v) for k, v in sorted(prec.prefill.items())} }; "
              f"prefix hits {st['prefix_hits']}, evictions "
              f"{st['cache_evictions']}", flush=True)
        bad = prec.decode_violations("AN3", pwant) \
            + prec.prefill_violations("AN3")
        if st["prefix_hits"] <= 0 or st["cache_evictions"] <= 0:
            bad.append("AN3: no prefix hit or no eviction")
        if bad:
            raise AssertionError("; ".join(bad))

        t = time.perf_counter()
        sweep_findings = []
        for c in (R.alpha_grid_contract(DEVICE),
                  R.traced_fields_contract(DEVICE)):
            sweep_findings += check_contract(c, "trace")
        print(f"AN6 sweep/alpha-axis-programs-once and "
              f"sweep/dynamic-fields-flow-from-row on the card: "
              f"{len(sweep_findings)} findings in "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        if sweep_findings:
            raise AssertionError(render(sweep_findings))
    print(f"AN5 nvcc runs during AN: {builds.count}", flush=True)
    if builds.count:
        raise AssertionError("AN5: phase AN built a kernel")
    print(f"phase AN in {time.perf_counter() - t_an:.1f} s; launches "
          f"fused_mvm={launches['fused_mvm']} flash_decode="
          f"{launches['flash_decode']} paged_attention="
          f"{launches['paged_attention']}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def swapped(module, **attrs):
    """``module``'s attributes replaced by ``attrs`` inside the block."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def with_spec(pack, **fields):
    """The same programmed pack with ``fields`` replaced in every spec
    (``fused="oracle"`` routes each site through the plain version;
    ``r_hat`` and ``use_pallas`` pick a path over the same conductances)."""
    from repro_torch.hw.profile import SiteSpecs

    def swap(spec):
        return dataclasses.replace(spec, **fields)

    bands = tuple(SiteSpecs(tuple((n, swap(s)) for n, s in ss.items))
                  for ss in pack.band_specs)
    head = None if pack.head_spec is None else swap(pack.head_spec)
    return dataclasses.replace(pack, band_specs=bands, head_spec=head)


def near_tie(torch, cfg, params, pack, prompt, ref, got,
             rel: float = 1e-4) -> bool:
    """True if ``got`` leaves ``ref`` only where the reference's top-2
    logit gap at the first diverging step is under ``rel`` of the logit
    scale (the near-tie rule)."""
    from repro_torch.models.transformer import forward

    diff = [i for i, (a, b) in enumerate(zip(ref, got)) if a != b]
    if not diff:
        return True
    i = diff[0]
    seq = torch.as_tensor(list(prompt) + list(ref[:i]), device=DEVICE)[None]
    logits = forward(cfg, params, seq, pack=pack)[0][0, -1]
    top2 = torch.topk(logits, 2).values
    return float(top2[0] - top2[1]) < rel * float(logits.abs().max())


def served_requests(cfg):
    """The main path's five requests: (prompt, token budget) pairs of
    prompts of 5, 11, 17, 24 and 3 tokens drawn from a seed."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
    return [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), m)
            for n, m in ((5, 8), (11, 6), (17, 8), (24, 7), (3, 5))]


def main_path(torch, args, kern_fused):
    from repro_torch.configs import get_config
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.models import transformer as T
    from repro_torch.serve import calibrate_lm, program_lm

    base = get_config("qwen1.5-4b")
    cfg = dataclasses.replace(base, n_layers=args.layers)
    print(f"main path: {cfg.name} at published width d={cfg.d_model} "
          f"H={cfg.n_heads} KV={cfg.n_kv_heads} hd={cfg.hd} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} dtype={cfg.dtype}; depth cut "
          f"to {cfg.n_layers} of {base.n_layers} layers; weights from seed "
          f"{SEED}", flush=True)
    t0 = time.perf_counter()
    params = T.init_params(cfg, SEED, device=DEVICE)
    spec = A.design_a(error=E.state_proportional(0.05), fused="kernel")
    pack = program_lm(cfg, params, spec, seed=7)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    calib = torch.randint(0, cfg.vocab, (4, 32), generator=gen, device=DEVICE)
    pack = calibrate_lm(cfg, params, pack, calib)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"programmed {len(pack.layer_weights)} sites x {cfg.n_layers} "
          f"layers + head in {t1 - t0:.2f} s; calibrated on 4x32 tokens in "
          f"{t2 - t1:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    reqs = served_requests(cfg)

    def serve(backend):
        return serve_requests(torch, cfg, params, pack, reqs, backend)

    kern_fused.reset_launch_counts()
    flash_out, wall, stats = serve("flash")
    counts = dict(kern_fused.LAUNCHES)
    steps = stats["decode_steps"]
    print(f"served {len(reqs)} requests ({stats['tokens_out']} tokens, "
          f"{stats['prefill_calls']} prefills, {steps} decode steps) through "
          f"ServeRuntime(attn_backend='flash') in {wall:.3f} s; launches "
          f"fused_mvm={counts['fused_mvm']} flash_decode="
          f"{counts['flash_decode']} (per decode step expected "
          f"{7 * cfg.n_layers + 1} fused_mvm, {cfg.n_layers} flash_decode; "
          f"got {counts['flash_decode'] / max(steps, 1):.1f} flash_decode)",
          flush=True)
    if counts["fused_mvm"] == 0 or counts["flash_decode"] == 0:
        raise AssertionError(f"a kernel of the main path never ran: {counts}")
    if counts["flash_decode"] != cfg.n_layers * steps:
        raise AssertionError("flash_decode launches != layers x steps")
    for (p, m), out in zip(reqs, flash_out):
        if out.shape != (m,) or out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError(f"bad completion {out} for budget {m}")

    stream_out, _, _ = serve("stream")
    agree = total = 0
    ties = 0
    for (p, m), s_out, f_out, ref in zip(
            reqs, stream_out, flash_out,
            decode_refs(torch, cfg, params, pack, reqs)):
        agree += int((s_out == ref).sum())
        total += m
        if (f_out != ref).any():
            if not near_tie(torch, cfg, params, pack, p, ref, f_out):
                raise AssertionError(f"flash runtime left decode_lm away from "
                                     f"a near tie: {f_out} vs {ref}")
            ties += 1
    print(f"runtime(stream) == decode_lm agreement {agree / total:.4f} "
          f"({agree}/{total}); runtime(flash) vs decode_lm: "
          f"{len(reqs) - ties}/{len(reqs)} requests identical, {ties} "
          f"near-tie departures", flush=True)
    if agree != total:
        raise AssertionError("ServeRuntime != decode_lm")

    logits_vs_plain(torch, cfg, params, pack, reqs[1][0])
    step = decode_step_s(torch, cfg, params, pack, reqs)
    return cfg, step, counts, params, pack, reqs, calib


def serve_requests(torch, cfg, params, pack, reqs, backend):
    """Serve ``reqs`` through ``ServeRuntime``: (outputs in request order,
    seconds, the runtime's stats)."""
    from repro_torch.serve import ServeRuntime

    rt = ServeRuntime(cfg, params, pack=pack, max_slots=4, max_len=MAX_LEN,
                      attn_backend=backend)
    uids = [rt.submit(p, max_new_tokens=m) for p, m in reqs]
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = rt.run()
    torch.cuda.synchronize()
    return [outs[u] for u in uids], time.perf_counter() - t, rt.stats


def decode_refs(torch, cfg, params, pack, reqs):
    """Each request's greedy tokens from ``decode_lm`` alone."""
    from repro_torch.serve import decode_lm

    return [decode_lm(cfg, params, torch.as_tensor(p)[None], m,
                      pack=pack)[0].cpu().numpy() for p, m in reqs]


def runtime_agreement(torch, cfg, params, pack, reqs, outs) -> float:
    """``ServeRuntime`` tokens against ``decode_lm``'s; raises unless every
    token agrees."""
    agree = total = 0
    for (p, m), out, ref in zip(reqs, outs,
                                decode_refs(torch, cfg, params, pack, reqs)):
        if out.shape != (m,) or out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError(f"bad completion {out} for budget {m}")
        agree += int((out == ref).sum())
        total += m
    if agree != total:
        raise AssertionError(f"ServeRuntime != decode_lm: {agree}/{total}")
    return agree / total


def logits_vs_plain(torch, cfg, params, pack, prompt,
                    legacy_ops=None) -> float:
    """The served logits of one prompt's prefill against the plain-version
    pack: ``fused="oracle"``, or on the legacy ``use_pallas`` route (pass
    the ``kernels.ops`` module as ``legacy_ops``) the same pack with
    ``ops.analog_mvm`` and ``ops.analog_mvm_parasitic`` on their plain
    versions; raises past 1e-3 of the logit scale or on a non-finite
    logit, and on the legacy route at any difference, since its kernels
    equal their plain versions to the bit."""
    from repro_torch.models.transformer import forward

    prompt = torch.as_tensor(prompt, device=DEVICE)[None]
    lg_k = forward(cfg, params, prompt, pack=pack)[0]
    if legacy_ops is None:
        lg_o = forward(cfg, params, prompt,
                       pack=with_spec(pack, fused="oracle"))[0]
    else:
        plain = {nm: functools.partial(getattr(legacy_ops, nm),
                                       backend="oracle")
                 for nm in ("analog_mvm", "analog_mvm_parasitic")}
        with swapped(legacy_ops, **plain):
            lg_o = forward(cfg, params, prompt, pack=pack)[0]
    dev = float((lg_k - lg_o).abs().max()) / float(lg_o.abs().max())
    what = "plain-version pack" if legacy_ops is None \
        else "the legacy kernels' plain versions"
    print(f"logits kernel pack vs {what} ({prompt.shape[1]}-token prefill): "
          f"max |diff| / max|logit| = {dev:.3e} (finite: "
          f"{bool(torch.isfinite(lg_k).all())})", flush=True)
    if not bool(torch.isfinite(lg_k).all()) or dev > 1e-3:
        raise AssertionError("served logits disagree with the plain version")
    if legacy_ops is not None and dev != 0.0:
        raise AssertionError("the legacy kernels' logits are not their plain "
                             "versions' to the bit")
    return dev


def decode_step_s(torch, cfg, params, pack, reqs) -> float:
    """Median seconds of one decode step, 4 rows decoding together through
    the flash path (steps 3..12 of 12)."""
    import numpy as np

    from repro_torch.models import transformer as T

    prompts = torch.as_tensor(np.stack([r[0][:3] for r in reqs[:4]]),
                              device=DEVICE)
    logits, cache = T.prefill(cfg, params, prompts, MAX_LEN, pack=pack)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = T.decode_step(cfg, params, tok, cache, pack=pack,
                                      attn_backend="flash")
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return sorted(times[2:])[len(times[2:]) // 2]


def path_p1(torch, cfg, params, pack, reqs, calib, kern_fused):
    """Path P1: the main path's conductances under parasitics (``r_hat``
    1e-4, ``fused="kernel"``), recalibrated and serving ``reqs``."""
    from repro_torch.serve import calibrate_lm

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kern_fused.reset_launch_counts()
    pack = calibrate_lm(cfg, params, with_spec(pack, r_hat=R_HAT), calib)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    outs, wall, stats = serve_requests(torch, cfg, params, pack, reqs,
                                       "stream")
    counts = dict(kern_fused.LAUNCHES)
    print(f"path P1 (r_hat {R_HAT:g}, fused kernel): calibrated in "
          f"{t_cal:.2f} s; served {len(reqs)} requests "
          f"({stats['tokens_out']} tokens, {stats['prefill_calls']} "
          f"prefills, {stats['decode_steps']} decode steps) in {wall:.3f} s; "
          f"launches {counts}", flush=True)
    if counts["fused_mvm_parasitic"] == 0 or counts["fused_mvm"]:
        raise AssertionError(f"path P1 did not run on the fused parasitic "
                             f"kernel alone: {counts}")
    agree = runtime_agreement(torch, cfg, params, pack, reqs, outs)
    dev = logits_vs_plain(torch, cfg, params, pack, reqs[1][0])
    step = decode_step_s(torch, cfg, params, pack, reqs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"path P1: runtime(stream) == decode_lm agreement {agree:.4f}; "
          f"decode step (4 rows, {cfg.n_layers} layers, flash attention) "
          f"{step * 1e3:.3f} ms, {4 / step:.1f} tokens/s; calibration "
          f"{t_cal:.2f} s; peak memory {peak:.2f} GiB", flush=True)
    return counts, {"step_s": step, "calib_s": t_cal, "logit_dev": dev}


def path_p2(torch, ops, tol, cfg, params, pack, reqs, calib, kern_fused,
            r_hat, step_reqs):
    """Path P2: the legacy ``use_pallas`` route on the main path's
    conductances at ``r_hat``, recalibrated and serving ``reqs``; then one
    prefill's logits against the plain legacy versions, the decode step
    timed at 4 rows (``step_reqs``' prompts) and, under parasitics, the
    bit-line kernel held at the shapes the calibration gave it.  Returns
    (launch counts, the bit-line kernel's totals or None)."""
    from repro_torch.serve import calibrate_lm

    bitline = ops.bitline_mvm
    seen = {}

    def recording(g, x, r, *, backend="kernel"):
        entry = seen.setdefault((tuple(g.shape), tuple(x.shape)), [g, x, 0])
        entry[2] += 1
        return bitline(g, x, r, backend=backend)

    t0 = time.perf_counter()
    kern_fused.reset_launch_counts()
    with swapped(ops, bitline_mvm=recording):
        pack = calibrate_lm(cfg, params, with_spec(pack, use_pallas=True,
                                                   fused="off", r_hat=r_hat),
                            calib)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    outs, wall, stats = serve_requests(torch, cfg, params, pack, reqs,
                                       "stream")
    counts = dict(kern_fused.LAUNCHES)
    agree = runtime_agreement(torch, cfg, params, pack, reqs, outs)
    print(f"path P2 (use_pallas, r_hat {r_hat:g}): calibrated in "
          f"{t_cal:.2f} s; served {len(reqs)} requests "
          f"({stats['tokens_out']} tokens, {stats['decode_steps']} decode "
          f"steps) in {wall:.3f} s; runtime(stream) == decode_lm agreement "
          f"{agree:.4f}; launches {counts}", flush=True)
    want = (("bitline_mvm", "analog_bitline_diff") if r_hat
            else ("analog_mvm_diff",))
    if any(counts[k] == 0 for k in want) or counts["fused_mvm"] \
            or counts["fused_mvm_parasitic"]:
        raise AssertionError(f"path P2 at r_hat {r_hat:g} did not run on "
                             f"{want}: {counts}")
    if sum(e[2] for e in seen.values()) != counts["bitline_mvm"]:
        raise AssertionError("a bit-line launch of the calibration was not "
                             "recorded")
    logits_vs_plain(torch, cfg, params, pack, reqs[1][0], legacy_ops=ops)
    step = decode_step_s(torch, cfg, params, pack, step_reqs)
    print(f"path P2 (use_pallas, r_hat {r_hat:g}): decode step (4 rows, "
          f"{cfg.n_layers} layers, flash attention) {step * 1e3:.3f} ms, "
          f"{4 / step:.1f} tokens/s", flush=True)
    bl = bitline_at_calibration(torch, ops, tol, seen, r_hat) if seen \
        else None
    return counts, bl


def path_pg(torch, cfg, params, pack, reqs, kern_fused):
    """Path PG: the main path's pack served through ``PagedServeRuntime``
    with prefix sharing (gather and kernel backends) on the main path's
    requests and three that share the 24-token prompt's first two pages.
    Returns (the kernel run's launch counts, its stats, the decode step's
    seconds)."""
    import numpy as np

    from repro_torch.serve import PagedServeRuntime

    rng = np.random.default_rng(SEED + 3)
    head = reqs[3][0][:2 * PAGE_SIZE]
    pg_reqs = list(reqs) + [
        (np.concatenate([head, rng.integers(0, cfg.vocab, size=n - len(head))])
         .astype(np.int32), m) for n, m in ((20, 6), (18, 8), (22, 4))]
    if any(p.size + m > MAX_LEN for p, m in pg_reqs):
        raise AssertionError("a path PG request exceeds max_len")
    dense, _, _ = serve_requests(torch, cfg, params, pack, pg_reqs, "stream")

    def serve_paged(backend):
        rt = PagedServeRuntime(cfg, params, pack=pack, page_size=PAGE_SIZE,
                               max_slots=4, max_len=MAX_LEN, backend=backend)
        cached = []
        prefill_cached = rt._api.prefill_cached

        def counting(*a, **kw):
            cached.append(kw["ctx_lens"].shape[0])
            return prefill_cached(*a, **kw)

        rt._api = dataclasses.replace(rt._api, prefill_cached=counting)
        uids = [rt.submit(p, max_new_tokens=m) for p, m in pg_reqs]
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = rt.run()
        torch.cuda.synchronize()
        rt.check()
        return ([outs[u] for u in uids], time.perf_counter() - t, rt.stats,
                len(cached))

    gather, _, g_stats, _ = serve_paged("gather")
    same = sum(bool(np.array_equal(a, b)) for a, b in zip(gather, dense))
    print(f"path PG (gather): {same}/{len(pg_reqs)} requests token for token "
          f"equal to the dense ServeRuntime; prefix hits "
          f"{g_stats['prefix_hits']}", flush=True)
    if same != len(pg_reqs):
        raise AssertionError("paged (gather) tokens != dense ServeRuntime")

    kern_fused.reset_launch_counts()
    outs, wall, stats, n_cached = serve_paged("kernel")
    counts = dict(kern_fused.LAUNCHES)
    steps = stats["decode_steps"]
    print(f"path PG (kernel): served {len(pg_reqs)} requests "
          f"({stats['tokens_out']} tokens, {stats['prefill_calls']} prefills, "
          f"{n_cached} through prefill_cached, {steps} decode steps) in "
          f"{wall:.3f} s; prefix hits {stats['prefix_hits']} "
          f"({stats['prefix_tokens_reused']} tokens reused); launches "
          f"{counts}", flush=True)
    if stats["prefix_hits"] < 1 or n_cached < 1:
        raise AssertionError("path PG never hit the prefix cache")
    if counts["paged_attention"] != cfg.n_layers * steps \
            or counts["flash_decode"] or counts["fused_mvm"] == 0:
        raise AssertionError(f"path PG launches: paged_attention != layers x "
                             f"steps, or flash_decode ran: {counts}")
    ties = 0
    for (p, m), out, ref in zip(pg_reqs, outs,
                                decode_refs(torch, cfg, params, pack, pg_reqs)):
        if out.shape != (m,) or out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError(f"bad completion {out} for budget {m}")
        if (out != ref).any():
            if not near_tie(torch, cfg, params, pack, p, ref, out):
                raise AssertionError(f"paged (kernel) runtime left decode_lm "
                                     f"away from a near tie: {out} vs {ref}")
            ties += 1
    print(f"path PG (kernel) vs decode_lm: {len(pg_reqs) - ties}/"
          f"{len(pg_reqs)} requests identical, {ties} near-tie departures",
          flush=True)
    step = paged_step_s(torch, cfg, params, pack)
    long_step = long_paged_step_s(torch, cfg, params, pack)
    print(f"path PG decode step at {LONG_POS} positions (4 rows, "
          f"{cfg.n_layers} layers, page {LONG_PAGE}, random pages): "
          f"{long_step * 1e3:.3f} ms", flush=True)
    return counts, stats, step


def long_paged_cache(torch, cfg, n_pos: int, page: int) -> dict:
    """A ``decode_step_paged`` cache of 4 rows that each hold ``n_pos``
    positions: a pool of random pages (``cfg.dtype``, seeded) of ``page``
    positions, one more page a row for the steps' own tokens, behind a
    shuffled block table."""
    from repro_torch.models import transformer as T

    b, npg = 4, n_pos // page + 1
    pool = T.init_page_pool(cfg, 1 + b * npg, page, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 62)
    for t in pool["attn"].values():
        t.copy_(torch.randn(t.shape, generator=gen, device=DEVICE))
    ptab = (1 + torch.randperm(b * npg, generator=gen, device=DEVICE)) \
        .reshape(b, npg).to(torch.int32)
    return {"pool": pool, "ptab": ptab,
            "len": torch.full((b,), n_pos, dtype=torch.int32, device=DEVICE)}


def paged_step_s(torch, cfg, params, pack, cache=None) -> float:
    """Median seconds of one paged decode step (``decode_step_paged``,
    kernel backend), 4 rows decoding together over the page pool (steps
    3..12 of 12), as :func:`decode_step_s` times the dense step; over the
    served pool after a prefill, or over ``cache`` (no tokens compared)."""
    import numpy as np

    from repro_torch.models import transformer as T
    from repro_torch.serve import PagedServeRuntime

    rng = np.random.default_rng(SEED + 4)
    if cache is None:
        rt = PagedServeRuntime(cfg, params, pack=pack, page_size=PAGE_SIZE,
                               max_slots=4, max_len=MAX_LEN, backend="kernel")
        for _ in range(4):
            rt.submit(rng.integers(0, cfg.vocab, size=3).astype(np.int32),
                      max_new_tokens=MAX_LEN - 3)
        rt.step()                      # prefill and the first decode step
        st = rt._state
        cache = {"pool": st.layers, "len": st.length,
                 "ptab": torch.as_tensor(rt._ptab, device=DEVICE)}
        tok = st.tok[:, None]
    else:
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(4, 1)),
                              device=DEVICE)
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = T.decode_step_paged(cfg, params, tok, cache,
                                            pack=pack, backend="kernel")
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return sorted(times[2:])[len(times[2:]) // 2]


LONG_POS = 2048       # positions a row holds in the long paged step
LONG_PAGE = 16


def long_paged_step_s(torch, cfg, params, pack) -> float:
    """:func:`paged_step_s` over a pool of random pages, 4 rows at
    ``LONG_POS`` positions each."""
    cache = long_paged_cache(torch, cfg, LONG_POS, LONG_PAGE)
    step = paged_step_s(torch, cfg, params, pack, cache)
    del cache
    torch.cuda.empty_cache()
    return step


def bitserial_full_width(torch, ops, tol, cfg, pack, kern_fused):
    """Design D at the main path's full-width sites: slice 0 of the pack's
    differential conductances at wq, w_gate, w_down (layer 0) and the head,
    4 activation rows quantized as the main path quantizes them, 7 bits,
    the ADC range from the plain version's per-bit pre-ADC values.  The op
    entry point is driven once per site with the counts reset just before
    and read just after; then each site is held against its plain version
    (within the bound and to the bit) and timed on the device alone (a
    CUDA graph of ten launches, as is its yardstick) beside the wrapper's
    time per call, its plain version, its bound and ``torch.matmul`` of
    the 7 stacked bit planes."""
    from repro_torch.core.adc import range_from_samples
    from repro_torch.core.quant import quantize_acts
    from repro_torch.kernels.fused import _bit_plane
    from repro_torch.kernels.ref import fused_pre_adc

    nb, m = 7, 4
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 300)
    sites = []
    for name in ("wq", "w_gate", "w_down", "head"):
        if name == "head":
            aw, spec = pack.head, pack.head_spec
        else:
            aw, spec = pack.layer_weights[name].layer(0), pack.site_spec(name)
        gp, gm = aw.g_pos[0], aw.g_neg[0]                 # (P, rows, N)
        p, rows, _ = gp.shape
        x = torch.randn((m, aw.k), generator=gen, device=DEVICE)
        xq = quantize_acts(x, spec.input_bits)
        x_parts = torch.nn.functional.pad(xq.values, (0, p * rows - aw.k)) \
            .reshape(m, p, rows).contiguous()
        lo, hi = range_from_samples(fused_pre_adc(x_parts, gp[None], gm[None],
                                                  nb))
        mp = spec.mapping
        gain = (mp.levels_per_cell - 1) / (1.0 - mp.g_min)
        sites.append((name, x_parts, gp, gm, dict(
            n_bits=nb, adc_lo=lo.reshape(1), adc_hi=hi.reshape(1),
            adc_bits=spec.adc.bits, gain=gain)))

    kern_fused.reset_launch_counts()
    outs = [ops.analog_mvm_bitserial(x, gp, gm, **kw)
            for _, x, gp, gm, kw in sites]
    torch.cuda.synchronize()
    launches = kern_fused.LAUNCHES["analog_mvm_bitserial"]
    if launches != len(sites):
        raise AssertionError(f"analog_mvm_bitserial launched {launches} times "
                             f"for {len(sites)} calls")
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "flops": 0.0, "max_abs_err": 0.0, "launches": launches}
    for (name, x, gp, gm, kw), y in zip(sites, outs):
        y_ref = ops.analog_mvm_bitserial(x, gp, gm, backend="oracle", **kw)
        torch.cuda.synchronize()
        r = tol.bitserial_check(y, y_ref, x, gp, gm, kw["adc_lo"],
                                kw["adc_hi"], kw["gain"],
                                adc_bits=kw["adc_bits"], n_bits=nb)
        if not r["ok"] or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"analog_mvm_bitserial at {name} outside "
                                 f"the bound: {r}")
        if not torch.equal(y, y_ref):
            raise AssertionError(f"analog_mvm_bitserial at {name} is not its "
                                 f"plain version to the bit")
        del y_ref

        def call():
            return ops.analog_mvm_bitserial(x, gp, gm, **kw)

        ms = graph_time(call)
        wrapper = cuda_time(call, reps=10)
        plain = cuda_time(lambda: ops.analog_mvm_bitserial(
            x, gp, gm, backend="oracle", **kw), reps=2, warmup=1)
        p, rows, n = gp.shape
        sign, mag = torch.sign(x), x.abs()
        planes = torch.cat([_bit_plane(mag, sign, b)
                            for b in range(nb)], dim=0)    # (7 M, P, rows)
        planes = planes.permute(1, 0, 2).contiguous()
        gd = gp - gm
        lib = graph_time(lambda: torch.matmul(planes, gd))
        del planes, gd
        n_bytes = 4 * (x.numel() + gp.numel() + gm.numel() + 2 + m * n)
        n_flops = 2 * m * nb * p * rows * n
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        print(f"analog_mvm_bitserial {name} (M={m} P={p} rows={rows} N={n} "
              f"n_bits={nb}): kernel {ms:.4f} ms (device; wrapper "
              f"{wrapper:.4f} ms)  plain {plain:.4f} ms  bound {b_ms:.4f} ms "
              f"({b_by})  torch.matmul(7 stacked planes) {lib:.4f} ms  "
              f"max_abs_err {r['max_abs_err']:.3e}  flips {r['flips']}  "
              f"equal to plain", flush=True)
        tot["max_abs_err"] = max(tot["max_abs_err"], r["max_abs_err"])
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bytes"] += n_bytes
        tot["flops"] += n_flops
        torch.cuda.empty_cache()
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot["bytes"], tot["flops"])
    return tot


# ---------------------------------------------------------------------------
# path PD: drift, stuck-cell faults and self-healing serving
# ---------------------------------------------------------------------------


def pack_tensors(pack) -> list:
    """Every tensor of a pack (conductances, scales, ranges), in order."""
    out = []
    for name in sorted(pack.layer_weights):
        aw = pack.layer_weights[name]
        out += [aw.g_pos, aw.g_neg, aw.g_unit, aw.w_scale]
    for d in (pack.layer_lo, pack.layer_hi, pack.layer_act):
        out += [d[n] for n in sorted(d)]
    if pack.head is not None:
        out += [pack.head.g_pos, pack.head.g_neg, pack.head.g_unit,
                pack.head.w_scale]
    return out + [pack.head_lo, pack.head_hi, pack.head_act]


def packs_equal(torch, a, b) -> bool:
    """``torch.equal`` on every tensor of two packs."""
    ta, tb = pack_tensors(a), pack_tensors(b)
    return len(ta) == len(tb) and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and torch.equal(x, y))
        for x, y in zip(ta, tb))


def timed_manager_class(torch, secs: dict):
    """A ``PackManager`` subclass whose aging, reprogramming, recalibration
    and probe methods add their synchronized seconds to ``secs``.  (A
    subclass, not wrappers set on an instance: those would hold the
    instance in a reference cycle, and its packs would outlive ``del``.)"""
    from repro_torch.serve import PackManager

    def timed(name, key):
        method = getattr(PackManager, name)

        def call(self, *a, **kw):
            t = time.perf_counter()
            out = method(self, *a, **kw)
            torch.cuda.synchronize()
            secs[key] = secs.get(key, 0.0) + time.perf_counter() - t
            return out
        return call

    return type("TimedPackManager", (PackManager,), {
        name: timed(name, key) for name, key in (
            ("aged", "age"), ("reprogram_band", "reprogram"),
            ("reprogram_head", "reprogram"), ("recalibrate", "recalibrate"),
            ("probe_loss", "probe"))})


def drift_spec(A, E):
    """benchmarks/driftbench.py's DRIFT_SPEC on the kernel route: Design A
    under 5% state-proportional error, power-law drift (nu 0.2, sigma_nu
    0.3) and stuck cells at 1e-5 per cell per t0 of age."""
    return A.design_a(error=E.state_proportional(0.05),
                      drift=E.power_law_drift(0.2, sigma_nu=0.3),
                      fault=E.stuck_faults(1e-5), fused="kernel")


def serve_managed(torch, cfg, params, reqs, paged=False, **kw):
    """Serve ``reqs`` through ``ServeRuntime(attn_backend="flash")`` or
    ``PagedServeRuntime(backend="kernel", page_size=8)``, with ``kw``
    (``manager=``, ``clock=``, ``heal=``, ``pack=``): (outputs in request
    order, the runtime)."""
    from repro_torch.serve import PagedServeRuntime, ServeRuntime

    if paged:
        rt = PagedServeRuntime(cfg, params, page_size=PAGE_SIZE,
                               backend="kernel", max_slots=4,
                               max_len=MAX_LEN, **kw)
    else:
        rt = ServeRuntime(cfg, params, attn_backend="flash", max_slots=4,
                          max_len=MAX_LEN, **kw)
    uids = [rt.submit(p, max_new_tokens=m) for p, m in reqs]
    outs = rt.run()
    if paged:
        rt.check()
    return [outs[u] for u in uids], rt


def healing_trace(torch, A, E, cfg, params, reqs, calib, steps: int,
                  heal: bool):
    """driftbench's healing trace on ``reqs``: a manager under
    ``drift_spec`` aged by ``DriftClock(PD_HORIZON / steps, 4)`` through
    the served run, healing under ``HealPolicy(check_every=4,
    bands_per_step=1)`` or not at all.  Returns (final probe loss, the
    fresh pack's, the runtime's stats, seconds per maintenance kind)."""
    from repro_torch.serve import DriftClock, HealPolicy

    secs: dict = {}
    m = timed_manager_class(torch, secs)(cfg, params, drift_spec(A, E),
                                         PD_SEED, calib_tokens=calib)
    clock = DriftClock(dt_per_step=PD_HORIZON / steps, update_every=4)
    policy = HealPolicy(check_every=4, bands_per_step=1) if heal else None
    outs, rt = serve_managed(torch, cfg, params, reqs, manager=m,
                             clock=clock, heal=policy)
    for (p, n), out in zip(reqs, outs):
        if out.shape != (n,) or out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError(f"bad completion {out} for budget {n}")
    loss = m.probe_loss(rt.pack)
    return loss, m.ref_loss, rt.stats, secs


def path_pd(torch, cfg, params, reqs, calib, kern_fused):
    """Path PD: drift, stuck-cell faults and self-healing on the main
    path's params, requests and calibration tokens, through B1, B2 (dense
    runtime) and B3 (paged runtime).  Four gates, each raising on failure:
    1. ``PackManager.aged(1.0)`` equals the fresh pack tensor for tensor;
       aging at ``PD_AGE`` differs and replays;
    2. healing that changes no value (``drift=power_law_drift(0.0)``, no
       programming error) leaves the served tokens as they were, dense and
       paged, with heal events, reprogrammed bands and a recalibration;
    3. on a pack reprogrammed at ``PD_HEAL_AT`` and recalibrated at
       ``PD_AGE``, the runtime agrees with ``decode_lm`` but at near ties;
    4. B1, B2 and B3 launch in PD's run, and B1's outputs at the probe's
       shape (M = 4 x 31) equal its plain version's on the aged pack.
    Then driftbench's healing trace, heal-off and heal-on, printed only.
    Returns PD's launch counts and its numbers."""
    import numpy as np

    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.kernels import ops
    from repro_torch.serve import HealPolicy

    t_pd = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern_fused.reset_launch_counts()
    secs: dict = {}
    Manager = timed_manager_class(torch, secs)

    # gate 1: the fresh age changes nothing; aging differs and replays
    t = time.perf_counter()
    m = Manager(cfg, params, drift_spec(A, E), PD_SEED, calib_tokens=calib)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    if not packs_equal(torch, m.aged(1.0), m.fresh_pack):
        raise AssertionError("path PD: aged(1.0) != the fresh pack")
    aged = m.aged(PD_AGE)
    if packs_equal(torch, aged, m.fresh_pack):
        raise AssertionError(f"path PD: aging to {PD_AGE} changed nothing")
    if not packs_equal(torch, aged, m.aged(PD_AGE)):
        raise AssertionError("path PD: aging does not replay")
    # gate 4's hold of B1 at the probe's shape: each launch of the probe
    # on the aged pack against its plain version on the same operands (the
    # plain version launches nothing)
    probe_rows = []
    fused_mvm = ops.fused_mvm

    def holding(x, gp, gm, **kw):
        y = fused_mvm(x, gp, gm, **kw)
        if not torch.equal(y, fused_mvm(x, gp, gm,
                                        **dict(kw, backend="oracle"))):
            raise AssertionError(f"path PD: B1 at the probe's shape "
                                 f"{tuple(x.shape)} x {tuple(gp.shape)} is "
                                 f"not its plain version to the bit")
        probe_rows.append(x.shape[0])
        return y

    with swapped(ops, fused_mvm=holding):
        aged_loss = m.probe_loss(aged)
    del aged
    if set(probe_rows) != {4 * (calib.shape[1] - 1)}:
        raise AssertionError(f"path PD: B1's probe rows {set(probe_rows)}")
    print(f"path PD gate 1: manager built (program + calibrate + probe) in "
          f"{build_s:.2f} s; aged(1.0) equal to the fresh pack, tensor for "
          f"tensor; aged({PD_AGE:g}) differs and replays; probe loss fresh "
          f"{m.ref_loss:.4f}, aged({PD_AGE:g}) {aged_loss:.4f}", flush=True)

    # gate 3: reprogram at PD_HEAL_AT, recalibrate at PD_AGE, serve
    for target in m.heal_targets():
        if target == "head":
            m.reprogram_head(t_now=PD_HEAL_AT)
        else:
            m.reprogram_band(target, t_now=PD_HEAL_AT)
    healed = m.recalibrate(m.aged(PD_AGE))
    healed_loss = m.probe_loss(healed)
    outs, rt = serve_managed(torch, cfg, params, reqs, pack=healed)
    ties = 0
    for (p, n), out, ref in zip(reqs, outs,
                                decode_refs(torch, cfg, params, healed, reqs)):
        if out.shape != (n,) or out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError(f"bad completion {out} for budget {n}")
        if (out != ref).any():
            if not near_tie(torch, cfg, params, healed, p, ref, out):
                raise AssertionError(f"path PD: runtime left decode_lm away "
                                     f"from a near tie on the healed pack: "
                                     f"{out} vs {ref}")
            ties += 1
    step = decode_step_s(torch, cfg, params, healed, reqs)
    print(f"path PD gate 3: reprogrammed {m.heal_targets()} at "
          f"{PD_HEAL_AT:g}, recalibrated at {PD_AGE:g} (probe loss "
          f"{healed_loss:.4f}); ServeRuntime(flash) vs decode_lm: "
          f"{len(reqs) - ties}/{len(reqs)} requests identical, {ties} "
          f"near-tie departures; decode step on the healed pack (4 rows, "
          f"{cfg.n_layers} layers, flash attention) {step * 1e3:.3f} ms",
          flush=True)
    del m, healed, rt

    # gate 2: healing that changes no value changes no token
    m0 = Manager(cfg, params, A.design_a(
        error=E.none(), drift=E.power_law_drift(0.0), fused="kernel"),
        PD_SEED, calib_tokens=calib)
    plain, rt = serve_managed(torch, cfg, params, reqs, manager=m0)
    steps = rt.stats["decode_steps"]
    force = HealPolicy(check_every=1, loss_mult=0.0, loss_add=-1.0,
                       bands_per_step=1)
    runs = {}
    for label, paged in (("dense", False), ("paged", True)):
        outs, rt = serve_managed(torch, cfg, params, reqs, paged=paged,
                                 manager=m0, heal=force)
        s = rt.stats
        same = sum(bool(np.array_equal(a, b)) for a, b in zip(outs, plain))
        runs[label] = (same, s)
        if same != len(reqs) or s["heal_events"] < 1 \
                or s["bands_reprogrammed"] < 2 or s["recalibrations"] < 1:
            raise AssertionError(f"path PD gate 2 ({label}): {same}/"
                                 f"{len(reqs)} requests equal to the unhealed "
                                 f"run; stats {s}")
    print("path PD gate 2: forced healing with aging that changes no value: "
          + "; ".join(f"{k} {same}/{len(reqs)} requests equal to the "
                      f"unhealed dense run ({s['heal_events']} heal events, "
                      f"{s['bands_reprogrammed']} bands reprogrammed, "
                      f"{s['recalibrations']} recalibrations)"
                      for k, (same, s) in runs.items()), flush=True)
    del m0, rt

    # driftbench's healing trace (printed only: random weights)
    trace = {}
    for heal in (False, True):
        trace[heal] = healing_trace(torch, A, E, cfg, params, reqs, calib,
                                    steps, heal)
    torch.cuda.synchronize()
    counts = dict(kern_fused.LAUNCHES)
    wall = time.perf_counter() - t_pd
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # gate 4: B1, B2, B3 launched (B1 held at the probe's shape in gate 1)
    if not (counts["fused_mvm"] and counts["flash_decode"]
            and counts["paged_attention"]):
        raise AssertionError(f"path PD did not launch B1, B2 and B3: {counts}")
    print(f"path PD gate 4: launches {counts}; B1 at the probe's shape "
          f"(M = {probe_rows[0]}) equal to its plain version in all "
          f"{len(probe_rows)} launches of the probe on the aged pack",
          flush=True)

    (off, ref, s_off, _), (on, _, s_on, heal_secs) = trace[False], trace[True]
    tol = ref * 1.35 + 0.2
    print(f"path PD healing trace (DriftClock {PD_HORIZON:g}/{steps} a step, "
          f"update_every 4; random weights, printed only): fresh probe loss "
          f"{ref:.4f}, tolerance ref*1.35+0.2 = {tol:.4f}; heal-off final "
          f"{off:.4f} ({'within' if off < tol else 'breaks'} tolerance, "
          f"{s_off['decode_steps']} decode steps); heal-on final {on:.4f} "
          f"({'within' if on < tol else 'breaks'} tolerance; "
          f"{s_on['heal_events']} heal events, {s_on['bands_reprogrammed']} "
          f"bands, {s_on['recalibrations']} recalibrations, probes "
          f"{[round(v, 4) for v in s_on['probe_losses']]})", flush=True)
    maint = {k: heal_secs.get(k, 0.0)
             for k in ("age", "reprogram", "recalibrate", "probe")}
    print(f"path PD maintenance seconds (heal-on trace): aging "
          f"{maint['age']:.3f}, reprogramming {maint['reprogram']:.3f}, "
          f"recalibrating {maint['recalibrate']:.3f}, probing "
          f"{maint['probe']:.3f}; over gates 1-3: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(secs.items()))
          + f"; peak memory {peak:.2f} GiB; path PD in {wall:.1f} s",
          flush=True)
    return counts, {"step_s": step, "maint_s": maint, "peak_gib": peak,
                    "wall_s": wall}


# ---------------------------------------------------------------------------
# path SW: the design-space sweep engine
# ---------------------------------------------------------------------------


SW_SEED = 1234        # the sweeps' trial seed (lm_accuracy's)
SW_DECODE_NEW = 8     # decode_match's greedy tokens per prompt


def sw_grids(A, E, S):
    """Path SW's two grids, one trial each: G1, lm_accuracy's scheme axis
    (proportional = differential + analog accumulation, offset = offset +
    digital) x alpha {0.02, 0.05} on Design A's 8-bit calibrated ADC and
    on/off 1e4 with ``fused="kernel"`` (4 points, 2 groups); G2,
    lm_parasitics' ``r_hat`` axis {1e-4, 1e-3} on the ``use_pallas`` route
    at alpha 0.02, ``test_n`` 4 (2 points, 1 group)."""
    base = A.design_a(error=E.state_proportional(0.0), fused="kernel")
    scheme = S.Axis(("mapping.scheme", "input_accum"),
                    (("differential", "analog"), ("offset", "digital")),
                    labels=("proportional", "offset"))
    g1 = S.SweepSpec(
        name="sw_lm_accuracy", base=base,
        axes=(scheme, S.Axis("error.alpha", (0.02, 0.05),
                             labels=("a0.02", "a0.05"))),
        trials=1, seed=SW_SEED)
    r_hats = (1e-4, 1e-3)
    g2 = S.SweepSpec(
        name="sw_lm_parasitics",
        base=dataclasses.replace(base, use_pallas=True, fused="off",
                                 error=E.state_proportional(0.02)),
        axes=(S.Axis("r_hat", r_hats,
                     labels=tuple(f"r{r:g}" for r in r_hats)),),
        trials=1, seed=SW_SEED, test_n=4)
    return g1, g2


@contextlib.contextmanager
def sw_phase_timer(torch, serve_eval, tag_of: dict, secs: dict):
    """Inside the block, ``serve_eval``'s programming, calibration, eval
    and decode calls add their synchronized seconds to
    ``secs[(point tag, phase)]``; the codes cache to ``secs[("codes",
    mapping)]``.  A point is known from the spec it is programmed with."""
    current = {}

    def timed(fn, phase):
        def call(*a, **kw):
            if phase == "program":
                current["tag"] = tag_of[a[2]]
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            key = (current.get("tag"), phase) if phase != "codes" \
                else ("codes", a[2].mapping.scheme)
            secs[key] = secs.get(key, 0.0) + time.perf_counter() - t
            return out
        return call

    with swapped(serve_eval, **{
            name: timed(getattr(serve_eval, name), phase)
            for name, phase in (("lm_program_codes", "codes"),
                                ("program_lm_from_codes", "program"),
                                ("calibrate_lm", "calibrate"),
                                ("analog_eval_metrics", "eval"),
                                ("decode_lm", "decode"))}):
        yield


def path_sw(torch, ops, cfg, params, calib, kern_fused):
    """Path SW: the sweep engine (``repro_torch.sweep``) at full width on
    the main path's params and calibration tokens, eval tokens 4 x 32 more
    from the calibration's generator (targets shifted by one), prompts
    their first 8 tokens, 8 greedy tokens each.  ``run_sweep`` drives G1
    (B1 in eval and decode on the differential points) and G2 (B5 in
    calibration, B6 in eval and decode) through one ``ServeEvaluator``;
    the launch counts are read from those two runs.  Gates, each raising
    on failure:
    SW1. every point's loss, top1 and decode_match equal
         ``serve_serial_reference``'s on the same spec and seed;
    SW2. G1 again with the same cache directory comes back all cached
         with equal values, and ``compile_groups`` gives G2 one group;
    SW3. G1's proportional_a0.05 point with ``ops.fused_mvm`` swapped for
         its plain version gives equal metrics and launches no B1;
    SW4. B1, B5 and B6 launched in the executor's runs.
    Printed: each point's metrics and seconds by phase, the digital loss,
    the claim proportional < offset at a0.05, seconds and peak memory.
    Returns (the executor runs' launch counts, SW's numbers)."""
    import tempfile

    from repro_torch import sweep as S
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.serve import analog_eval_metrics
    from repro_torch.sweep import serve_eval

    t_sw = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    if not torch.equal(torch.randint(0, cfg.vocab, calib.shape,
                                     generator=gen, device=DEVICE), calib):
        raise AssertionError("path SW: the calibration tokens' generator "
                             "does not replay")
    tokens = torch.randint(0, cfg.vocab, (4, 32), generator=gen,
                           device=DEVICE)
    targets = torch.roll(tokens, -1, dims=1)
    prompts = tokens[:, :8]
    digital = float(analog_eval_metrics(cfg, params, None, tokens,
                                        targets)["loss"])
    ev = S.ServeEvaluator(cfg, params, calib, tokens, targets,
                          prompts=prompts, decode_new=SW_DECODE_NEW)
    g1, g2 = sw_grids(A, E, S)
    tag_of = {p.spec: p.tag for g in (g1, g2) for p in g.expand()}
    secs: dict = {}
    with tempfile.TemporaryDirectory() as cache_dir:
        kern_fused.reset_launch_counts()
        with sw_phase_timer(torch, serve_eval, tag_of, secs):
            res = {g.name: S.run_sweep(g, ev, cache_dir=cache_dir)
                   for g in (g1, g2)}
        torch.cuda.synchronize()
        counts = dict(kern_fused.LAUNCHES)
        run_s = time.perf_counter() - t_sw

        # SW1: the executor equals the serial loop
        for g in (g1, g2):
            n = g.test_n
            for pt in g.expand():
                ref = S.serve_serial_reference(
                    cfg, params, pt.spec, calib, tokens[:n], targets[:n],
                    prompts=prompts, decode_new=SW_DECODE_NEW,
                    trials=g.trials, seed=g.seed)
                if res[g.name][pt.tag].values != ref:
                    raise AssertionError(
                        f"path SW1: {g.name} {pt.tag}: run_sweep "
                        f"{res[g.name][pt.tag].values} != "
                        f"serve_serial_reference {ref}")
        print(f"path SW1: run_sweep == serve_serial_reference on all "
              f"{len(g1.expand()) + len(g2.expand())} points (loss, top1, "
              f"decode_match equal)", flush=True)

        # SW2: cache resume; G2 is one compile group
        again = S.run_sweep(g1, ev, cache_dir=cache_dir)
        if again.n_cached != len(again) or any(
                r.values != res[g1.name][r.tag].values for r in again):
            raise AssertionError(f"path SW2: {again.n_cached}/{len(again)} "
                                 f"points cached, or values differ")
        pts2 = g2.expand()
        groups2 = S.compile_groups([(str(p.index), p) for p in pts2], ev,
                                   all_points=pts2)
        if len(groups2) != 1:
            raise AssertionError(f"path SW2: G2 in {len(groups2)} groups")
    print(f"path SW2: G1 again from its cache: {again.n_cached}/{len(again)}"
          f" points cached, values equal; G2 one compile group "
          f"(dynamic {groups2[0][1]})", flush=True)

    # SW3: the kernel route equals the plain route
    tag = "proportional_a0.05"
    one = S.SweepSpec.from_points(
        "sw_plain", [(tag, next(p.spec for p in g1.expand()
                                if p.tag == tag))],
        trials=g1.trials, seed=g1.seed)
    fused_mvm = ops.fused_mvm

    def on_plain(*a, **kw):
        return fused_mvm(*a, **dict(kw, backend="oracle"))

    before = kern_fused.LAUNCHES["fused_mvm"]
    with swapped(ops, fused_mvm=on_plain):
        plain = S.run_sweep(one, ev)
    if kern_fused.LAUNCHES["fused_mvm"] != before:
        raise AssertionError("path SW3: the plain route launched B1")
    if plain[tag].values != res[g1.name][tag].values:
        raise AssertionError(f"path SW3: {tag} on B1's plain version "
                             f"{plain[tag].values} != on B1 "
                             f"{res[g1.name][tag].values}")
    print(f"path SW3: {tag} with ops.fused_mvm on its plain version: "
          f"{plain[tag].values[0]} == the kernel route's", flush=True)

    # SW4: the kernels ran
    sw_launch = {k: counts[k] for k in ("fused_mvm", "bitline_mvm",
                                        "analog_bitline_diff")}
    if not all(sw_launch.values()):
        raise AssertionError(f"path SW4: a kernel of SW never ran: {counts}")
    print(f"path SW4: launches in the executor's runs {counts}", flush=True)
    del ev
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_sw
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    for g in (g1, g2):
        for r in res[g.name]:
            v = r.values[0]
            split = ", ".join(f"{ph} {secs.get((r.tag, ph), 0.0):.3f}"
                              for ph in ("program", "calibrate", "eval",
                                         "decode"))
            print(f"path SW {g.name} {r.tag}: loss {v['loss']:.4f} top1 "
                  f"{v['top1']:.4f} decode_match {v['decode_match']:.4f}; "
                  f"wall_s {r.wall_s:.3f} ({split})", flush=True)
    codes = {k[1]: v for k, v in secs.items() if k[0] == "codes"}
    prop = res[g1.name]["proportional_a0.05"].metric_mean("loss")
    off = res[g1.name]["offset_a0.05"].metric_mean("loss")
    print(f"path SW: digital loss {digital:.4f}; proportional < offset at "
          f"a0.05: {prop < off} ({prop:.4f} vs {off:.4f}; random weights, "
          f"printed only); codes cache built in "
          + ", ".join(f"{k} {v:.3f} s" for k, v in codes.items())
          + f"; the executor's runs {run_s:.1f} s; path SW in {wall:.1f} s; "
          f"peak memory {peak:.2f} GiB", flush=True)
    return sw_launch, {"wall_s": wall, "run_s": run_s, "peak_gib": peak,
                       "secs": secs}


# ---------------------------------------------------------------------------
# path RW and phase FAM: the other model families
# ---------------------------------------------------------------------------

RW_PROMPT, RW_NEW = 16, 8       # RW's 4 prompts of 16 tokens, 8 new each
FAM_PROMPT, FAM_NEW = 8, 4      # FAM's analog check: 4 prompts x 8, 4 new
ATOL_PREFILL, ATOL_DECODE, RTOL = 2e-3, 3e-3, 2e-2  # tests/test_arch_smoke


def b1_at_sites(torch, A, E, ops, tol, sites, ms=(4, 128)) -> dict:
    """B1 against its plain version to the bit at each (name, K, N) site,
    for each row count in ``ms``, on Design-A conductances of a random
    weight; timed at M = 4 on the device alone beside the plain version.
    Launches here hold the kernel and are not a path's."""
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for i, (name, k, n) in enumerate(sites):
        gp, gm, inputs = full_width_site(torch, A, E, k, n, ms,
                                         SEED + 300 + i)
        line = []
        for x, lo, hi, scale in inputs:
            kw = dict(adc_lo=lo, adc_hi=hi, adc_bits=8, cell_bits=7,
                      n_bits=None, scale=scale)
            y = ops.fused_mvm(x, gp, gm, backend="kernel", **kw)
            y_ref = ops.fused_mvm(x, gp, gm, backend="oracle", **kw)
            torch.cuda.synchronize()
            r = tol.fused_mvm_check(y, y_ref, x, gp, gm, lo, hi, scale,
                                    adc_bits=8, cell_bits=7, n_bits=None)
            if not r["ok"] or not torch.equal(y, y_ref):
                raise AssertionError(f"B1 at {name} M={x.shape[0]} is not "
                                     f"its plain version to the bit: {r}")
            out["max_abs_err"] = max(out["max_abs_err"], r["max_abs_err"])
            line.append(f"M={x.shape[0]} equal to plain")
        x, lo, hi, scale = inputs[0]
        kw = dict(adc_lo=lo, adc_hi=hi, adc_bits=8, cell_bits=7, n_bits=None,
                  scale=scale)
        ms_k = graph_time(lambda: ops.fused_mvm(x, gp, gm, backend="kernel",
                                                **kw))
        ms_p = cuda_time(lambda: ops.fused_mvm(x, gp, gm, backend="oracle",
                                               **kw), reps=2, warmup=1)
        out["ms"] += ms_k
        out["plain_ms"] += ms_p
        print(f"B1 at {name} (K={k}, N={n}, P={x.shape[1]} partitions of "
              f"{x.shape[2]} rows): {'; '.join(line)}; M=4 kernel "
              f"{ms_k:.4f} ms (device), plain {ms_p:.3f} ms", flush=True)
        del gp, gm, inputs
        torch.cuda.empty_cache()
    return out


def consistency(torch, api, cfg, params, tokens, kw) -> dict:
    """Prefill then one ``decode_step`` against the forward over S + 1
    tokens (``tests/test_arch_smoke.py``): the largest excess over
    ``atol + rtol * |forward|`` of the prefill's and the decode's logits
    (<= 0 passes) and their largest differences."""
    s = tokens.shape[1]
    lf = api.forward(cfg, params, tokens, **kw)[0]
    lp, cache = api.prefill(cfg, params, tokens, s + 4, **kw)
    nt = torch.argmax(lp, -1).to(torch.int32)
    ld, cache = api.decode_step(cfg, params, nt, cache)
    lf2, aux = api.forward(cfg, params, torch.cat([tokens, nt], 1), **kw)

    def excess(a, b, atol):
        d = (a - b).abs()
        return float((d - atol - RTOL * b.abs()).max()), float(d.max())

    e_p, d_p = excess(lp[:, 0], lf[:, -1], ATOL_PREFILL)
    e_d, d_d = excess(ld[:, 0], lf2[:, -1], ATOL_DECODE)
    finite = bool(torch.isfinite(lf2).all() and torch.isfinite(ld).all())
    drop = aux.get("moe/drop_frac")
    return {"excess": max(e_p, e_d), "prefill_diff": d_p, "decode_diff": d_d,
            "finite": finite,
            "drop_frac": None if drop is None else float(drop.max())}


def hold_consistency(torch, label, api, cfg, params, tokens, kw):
    """``consistency`` in float32 (the reference's tolerance is a float32
    one), raising past it; the served dtype's differences printed."""
    gate = consistency(torch, api, dataclasses.replace(cfg, dtype="float32"),
                       params, tokens, kw)
    served = consistency(torch, api, cfg, params, tokens, kw)
    print(f"{label}: prefill + decode_step vs forward over S+1 in float32: "
          f"max diff prefill {gate['prefill_diff']:.3e}, decode "
          f"{gate['decode_diff']:.3e} (within atol {ATOL_PREFILL}/"
          f"{ATOL_DECODE} + rtol {RTOL}: {gate['excess'] <= 0}); in "
          f"{cfg.dtype}: {served['prefill_diff']:.3e} / "
          f"{served['decode_diff']:.3e} (printed only)"
          + ("" if gate["drop_frac"] is None
             else f"; MoE drop_frac {gate['drop_frac']}"), flush=True)
    if gate["excess"] > 0 or not gate["finite"] or not served["finite"]:
        raise AssertionError(f"{label}: prefill/decode disagree with the "
                             f"forward past the reference's tolerance")
    if gate["drop_frac"]:
        raise AssertionError(f"{label}: the forward dropped tokens")


def path_rw(torch, ops, tol, args, kern_fused):
    """Path RW: rwkv6-3b at its published width (d 2560, 40 heads of 64,
    d_ff 8960, vocab 65536, bfloat16), weights from a seed, depth cut to
    ``--layers``, every one of its eight projections per layer and its
    head on arrays (the main path's Design A, ``fused="kernel"``):
    ``program_lm``, ``calibrate_lm`` on 4 x 32 tokens, ``decode_lm`` on 4
    prompts of 16 tokens, 8 new each; B1's launches are read from that
    run.  Gates, each raising on failure:
    RW1. the tokens equal the same pack's with B1 on its plain version
         (``fused="oracle"``), and so do the prefill logits
         (``torch.equal``);
    RW2. digitally, prefill then one ``decode_step`` matches the forward
         over S + 1 tokens under ``tests/test_arch_smoke.py``'s tolerance
         (in float32; the bfloat16 differences printed);
    RW3. the chunked recurrence equals ``decay_recurrence_naive`` within
         the reference's bound (rtol 3e-4, atol 3e-5 on y, 5e-5 on the
         state) at the full-width shapes (4 x 32 tokens, 40 heads of 64),
         float32, in both modes;
    RW4. B1 launched, and equals its plain version at the ``ck`` (N =
         8960) and ``cv`` (K = 8960) sites and at the head, M = 4 and 128.
    Printed: decode-step time, calibration seconds and peak memory.
    Returns (B1 launches, RW's numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    from repro_torch.serve import calibrate_lm, decode_lm, program_lm

    t_rw = time.perf_counter()
    base = get_config("rwkv6-3b")
    cfg = dataclasses.replace(base, n_layers=args.layers)
    print(f"path RW: {cfg.name} at published width d={cfg.d_model} "
          f"H={cfg.n_heads}x{cfg.d_model // cfg.n_heads} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} dtype={cfg.dtype}; depth cut to {cfg.n_layers} "
          f"of {base.n_layers} layers; weights from seed {SEED}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, SEED, device=DEVICE)
    spec = A.design_a(error=E.state_proportional(0.05), fused="kernel")
    t0 = time.perf_counter()
    pack = program_lm(cfg, params, spec, seed=7)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    calib = torch.randint(0, cfg.vocab, (4, 32), generator=gen, device=DEVICE)
    pack = calibrate_lm(cfg, params, pack, calib)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prompts = torch.randint(0, cfg.vocab, (4, RW_PROMPT), generator=gen,
                            device=DEVICE)
    kern_fused.reset_launch_counts()
    toks = decode_lm(cfg, params, prompts, RW_NEW, pack=pack)
    torch.cuda.synchronize()
    launches = kern_fused.LAUNCHES["fused_mvm"]
    n_sites = len(pack.layer_weights) * cfg.n_layers + 1
    print(f"path RW: programmed {len(pack.layer_weights)} sites x "
          f"{cfg.n_layers} layers + head in {t1 - t0:.2f} s; calibrated on "
          f"4x32 tokens in {t2 - t1:.2f} s; decode_lm of 4x{RW_PROMPT} "
          f"prompts, {RW_NEW} new tokens each: {toks.tolist()}; B1 "
          f"launches {launches} (expected {n_sites} a step x {RW_NEW} "
          f"steps = {n_sites * RW_NEW})", flush=True)
    if toks.shape != (4, RW_NEW) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"path RW: bad tokens {toks}")

    # RW1: the same pack on B1's plain version
    plain = with_spec(pack, fused="oracle")
    toks_p = decode_lm(cfg, params, prompts, RW_NEW, pack=plain)
    lg_k = T.prefill(cfg, params, prompts, RW_PROMPT, pack=pack)[0]
    lg_p = T.prefill(cfg, params, prompts, RW_PROMPT, pack=plain)[0]
    rw1 = torch.equal(toks, toks_p) and torch.equal(lg_k, lg_p)
    print(f"RW1: decode_lm tokens through B1 == plain route: "
          f"{torch.equal(toks, toks_p)}; prefill logits equal: "
          f"{torch.equal(lg_k, lg_p)} (finite: "
          f"{bool(torch.isfinite(lg_k).all())})", flush=True)
    if not rw1 or not bool(torch.isfinite(lg_k).all()):
        raise AssertionError("path RW: RW1 failed")

    # decode-step time at 4 rows (median of steps 3..12)
    logits, cache = T.prefill(cfg, params, prompts, RW_PROMPT, pack=pack)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = T.decode_step(cfg, params, tok, cache, pack=pack)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    step_s = sorted(times[2:])[len(times[2:]) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    del pack, plain, cache
    torch.cuda.empty_cache()

    # RW2: digital prefill/decode consistency
    hold_consistency(torch, "RW2", get_model(cfg), cfg, params, prompts, {})
    del params
    torch.cuda.empty_cache()

    # RW3: the chunked recurrence at the full-width shapes, both modes
    b, s, h, hd = 4, 32, cfg.n_heads, cfg.d_model // cfg.n_heads
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)

    def rnd(*shape, sc=0.5):
        return torch.randn(shape, generator=g, device=DEVICE) * sc

    r, k, v = rnd(b, s, h, hd), rnd(b, s, h, hd), rnd(b, s, h, hd)
    lw = -torch.exp(rnd(b, s, h, hd))
    worst = 0.0
    for u, chunk in ((rnd(h, hd, sc=0.3), 32), (None, 64)):
        y1, s1 = R.chunked_decay_recurrence(r, k, v, lw, u=u, chunk=chunk)
        y2, s2 = R.decay_recurrence_naive(r, k, v, lw, u=u)
        ok = torch.allclose(y1, y2, rtol=3e-4, atol=3e-5) \
            and torch.allclose(s1, s2, rtol=3e-4, atol=5e-5)
        worst = max(worst, float((y1 - y2).abs().max()),
                    float((s1 - s2).abs().max()))
        if not ok:
            raise AssertionError(f"path RW: RW3 failed in "
                                 f"{'mamba' if u is None else 'rwkv'} mode")
    print(f"RW3: chunked recurrence == decay_recurrence_naive at "
          f"{b}x{s}x{h}x{hd} in float32, rwkv (chunk 32) and mamba (chunk 64) "
          f"modes, within rtol 3e-4 / atol 3e-5 (y), 5e-5 (state); max "
          f"|diff| {worst:.3e}", flush=True)

    # RW4: B1 at the ck, cv and head sites
    if launches == 0:
        raise AssertionError("path RW: B1 never launched")
    sites = b1_at_sites(torch, A, E, ops, tol,
                        [("rwkv_ck", cfg.d_model, cfg.d_ff),
                         ("rwkv_cv", cfg.d_ff, cfg.d_model),
                         ("head", cfg.d_model, cfg.vocab)])
    print(f"RW4: B1 launched {launches} times in RW's run and equals its "
          f"plain version at ck, cv and the head, M = 4 and 128", flush=True)
    print(f"path RW decode step (4 rows, {cfg.n_layers} layers, "
          f"{n_sites} B1 sites): {step_s * 1e3:.3f} ms, "
          f"{4 / step_s:.1f} tokens/s; calibration {t2 - t1:.2f} s; peak "
          f"memory {peak:.2f} GiB; path RW in "
          f"{time.perf_counter() - t_rw:.1f} s", flush=True)
    return launches, {"step_s": step_s, "calib_s": t2 - t1, "peak": peak,
                      "max_abs_err": sites["max_abs_err"]}


def fam_analog(torch, cfg, params, kern_fused, kw_calib) -> int:
    """Program and calibrate ``cfg`` (the main path's Design A with
    ``fused="kernel"``) and serve 4 prompts through ``decode_lm``: the
    tokens must equal the plain route's.  Returns B1's launches in the
    kernel route's run."""
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.serve import calibrate_lm, decode_lm, program_lm

    spec = A.design_a(error=E.state_proportional(0.05), fused="kernel")
    pack = program_lm(cfg, params, spec, seed=7)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    n_pre = cfg.n_frontend_tokens if kw_calib else 0
    calib = torch.randint(0, cfg.vocab, (4, n_pre + 32), generator=gen,
                          device=DEVICE)
    pack = calibrate_lm(cfg, params, pack, calib, **kw_calib)
    prompts = torch.randint(0, cfg.vocab, (4, FAM_PROMPT), generator=gen,
                            device=DEVICE)
    kern_fused.reset_launch_counts()
    toks = decode_lm(cfg, params, prompts, FAM_NEW, pack=pack)
    torch.cuda.synchronize()
    launches = kern_fused.LAUNCHES["fused_mvm"]
    toks_p = decode_lm(cfg, params, prompts, FAM_NEW,
                       pack=with_spec(pack, fused="oracle"))
    print(f"FAM {cfg.name}: {len(pack.layer_weights)} analog sites x "
          f"{cfg.n_layers} layers + head; decode_lm through B1 == plain "
          f"route: {torch.equal(toks, toks_p)} ({toks.tolist()}); B1 "
          f"launches {launches}", flush=True)
    if not torch.equal(toks, toks_p) or launches == 0:
        raise AssertionError(f"FAM {cfg.name}: the kernel route's tokens "
                             f"differ from the plain route's, or B1 never "
                             f"launched")
    return launches


def phase_fam(torch, kern_fused) -> int:
    """Phase FAM: the other families on the card at published width.
    Digitally (gate in float32 under ``tests/test_arch_smoke.py``'s
    tolerance, bfloat16 printed): qwen3-moe-235b-a22b at 1 layer (capacity
    factor n_experts / top_k, so no token drops and the forward and the
    decode route the same tokens), internvl2-26b at 2 layers with prefix
    embeddings, zamba2-7b at 6 layers (one shared-attention application),
    whisper-large-v3 at 2 + 2 layers over 1500 frames.  Through the analog
    engine (B1): qwen3-moe, internvl2 and arctic-480b at its smoke config
    (one layer of its experts is 53.5 GB in float32), ``decode_lm`` equal
    to the plain route; an MoE forward twice gives equal logits.  Returns
    B1's launches in FAM's kernel-route runs."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.registry import get_model

    t_fam = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    launches = 0

    def prefix(cfg, b):
        return torch.randn((b, cfg.n_frontend_tokens, cfg.d_model),
                           generator=gen, device=DEVICE) * 0.02

    cases = [
        ("qwen3-moe-235b-a22b", dict(n_layers=1), True),
        ("internvl2-26b", dict(n_layers=2), True),
        ("zamba2-7b", dict(n_layers=6), False),
        ("whisper-large-v3", dict(n_layers=2, n_enc_layers=2), False),
    ]
    for arch, cut, analog in cases:
        base = get_config(arch)
        cfg = dataclasses.replace(base, **cut)
        if cfg.n_experts:
            cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        api = get_model(cfg)
        t = time.perf_counter()
        params = api.init_params(cfg, SEED, device=DEVICE)
        # a vlm prompt carries its patch embeddings in its first positions
        n_pre = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
        tokens = torch.randint(0, cfg.vocab, (4, n_pre + 16), generator=gen,
                               device=DEVICE)
        kw = {} if not cfg.frontend else {"prefix_embeds": prefix(cfg, 4)}
        hold_consistency(torch, f"FAM {arch} (d={cfg.d_model}, "
                         f"{cfg.n_layers} layers)", api, cfg, params,
                         tokens, kw)
        if cfg.n_experts:
            a = api.forward(cfg, params, tokens)[0]
            b = api.forward(cfg, params, tokens)[0]
            print(f"FAM {arch}: the MoE forward twice gives equal logits: "
                  f"{torch.equal(a, b)}", flush=True)
            if not torch.equal(a, b):
                raise AssertionError(f"FAM {arch}: MoE forward not "
                                     f"deterministic")
        if analog:
            kw_calib = {} if not cfg.frontend \
                else {"prefix_embeds": prefix(cfg, 4)}
            launches += fam_analog(torch, cfg, params, kern_fused, kw_calib)
        print(f"FAM {arch} in {time.perf_counter() - t:.1f} s", flush=True)
        del params
        torch.cuda.empty_cache()
    cfg = get_smoke_config("arctic-480b")
    params = get_model(cfg).init_params(cfg, SEED, device=DEVICE)
    launches += fam_analog(torch, cfg, params, kern_fused, {})
    print(f"phase FAM in {time.perf_counter() - t_fam:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; B1 launches "
          f"{launches}", flush=True)
    return launches


TR_BATCH, TR_MICRO = 2, 2     # train_4k's global batch cut 256 -> 2
TR_STEPS = 4                   # TR1's steps (a fifth repeats step 4's batch)
TR_LR, TR_WARMUP, TR_TOTAL = 3e-4, 2, 8
TR2_RTOL = 1e-4                # microbatches 2 against 1, float32
TR_EMBED_REL = 1e-5            # TR3's hold on the embedding's leaves


def tr_leaves(state) -> dict:
    """name -> tensor of a ``TrainState`` (the checkpoint's leaf names)."""
    from repro_torch.pytree import flatten_with_path

    return dict(flatten_with_path(state))


def tr_step_fn(cfg, microbatches: int):
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS

    return TS.train_step_fn(
        cfg, microbatches=microbatches, max_grad_norm=1.0, weight_decay=0.1,
        lr_schedule=adamw.cosine_schedule(TR_LR, TR_WARMUP, TR_TOTAL))


def tr2_microbatches(torch, base, shape) -> None:
    """TR2: from one state and batch, microbatches 2 against 1 in float32
    at 1 layer (bf16's rounding kept out): loss and grad norm within
    ``TR2_RTOL`` relative."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.train import step as TS

    cfg = dataclasses.replace(base, n_layers=1, dtype="float32")
    state = TS.make_train_state(cfg, SEED, device=DEVICE)
    batch = SyntheticLM(cfg, shape.seq_len, TR_BATCH, seed=0,
                        device=DEVICE).batch(0)
    out = {}
    for mb in (1, 2):
        _, m = tr_step_fn(cfg, mb)(state, batch)
        out[mb] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        torch.cuda.empty_cache()
    rel = {k: abs(out[2][k] - out[1][k]) / abs(out[1][k])
           for k in ("loss", "grad_norm")}
    print(f"TR2: float32, 1 layer, batch {TR_BATCH} x {shape.seq_len}: "
          f"microbatches 1 loss {out[1]['loss']:.7f} grad norm "
          f"{out[1]['grad_norm']:.7f}; microbatches 2 loss "
          f"{out[2]['loss']:.7f} grad norm {out[2]['grad_norm']:.7f}; "
          f"relative differences {rel['loss']:.3e}, {rel['grad_norm']:.3e} "
          f"(bound {TR2_RTOL:g})", flush=True)
    if not all(r <= TR2_RTOL for r in rel.values()):
        raise AssertionError("path TR: TR2 failed")


def tr3_remat(torch, cfg, state, batch) -> None:
    """TR3: one step with remat on against off from the same state.  The
    embedding's leaves (its gradient comes from CUDA's indexed
    scatter-add) within ``TR_EMBED_REL`` of their largest magnitude, every
    other leaf ``torch.equal``; the gradients of one microbatch are also
    compared the same way, and whether the embedding's came out equal is
    printed."""
    from repro_torch.pytree import flatten_with_path
    from repro_torch.train import step as TS

    def split(pairs) -> tuple:
        embed_equal, worst, unequal = True, 0.0, []
        for n, a, b in pairs:
            if n.split("/")[-1] == "embed":
                embed_equal &= torch.equal(a, b)
                scale = float(b.abs().max()) or 1.0
                worst = max(worst, float((a - b).abs().max()) / scale)
            elif not torch.equal(a, b):
                unequal.append(n)
        return embed_equal, worst, unequal

    cfg_on = dataclasses.replace(cfg, remat=True)
    cfg_off = dataclasses.replace(cfg, remat=False)
    mb = {k: v[:TR_BATCH // TR_MICRO] for k, v in batch.items()}
    _, _, g_on = TS.loss_and_grads(cfg_on, state.params, mb)
    _, _, g_off = TS.loss_and_grads(cfg_off, state.params, mb)
    g_eq, g_worst, g_bad = split(
        (n, a, b) for (n, a), (_, b) in zip(flatten_with_path(g_on),
                                            flatten_with_path(g_off)))
    del g_on, g_off
    torch.cuda.empty_cache()
    on, m_on = tr_step_fn(cfg_on, TR_MICRO)(state, batch)
    torch.cuda.empty_cache()
    off, m_off = tr_step_fn(cfg_off, TR_MICRO)(state, batch)
    off = tr_leaves(off)
    s_eq, s_worst, s_bad = split((n, t, off[n])
                                 for n, t in tr_leaves(on).items())
    metrics_equal = all(torch.equal(m_on[k], m_off[k])
                        for k in ("loss", "grad_norm"))
    print(f"TR3: remat on vs off from step {int(state.step)}'s state: "
          f"gradients of one microbatch equal but the embedding's: "
          f"{not g_bad} (embedding equal: {g_eq}, max rel diff "
          f"{g_worst:.3e}); after the step, loss and grad norm equal: "
          f"{metrics_equal}; params, mu and nu equal but the embedding's: "
          f"{not s_bad} (embedding equal: {s_eq}, max rel diff "
          f"{s_worst:.3e}; bound {TR_EMBED_REL:g})", flush=True)
    if g_bad or s_bad or max(g_worst, s_worst) > TR_EMBED_REL:
        raise AssertionError(f"path TR: TR3 failed: {g_bad or s_bad}")


def tr4_checkpoint(torch, step, state, ds, k: int) -> tuple:
    """TR4: ``save_async`` of the whole state while the next step runs,
    then ``restore`` onto the card: every leaf, the step and ``extra``
    equal, and the data pipeline rebuilt from ``extra`` replays step
    ``k``'s batch.  Writes under the checkout's ``build/`` (checked for
    twice the state's size first) and deletes it after.  Returns (state
    after step k, GB, save s, restore s)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.synthetic import SyntheticLM

    leaves = tr_leaves(state)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
    (ROOT / "build").mkdir(exist_ok=True)
    ck_dir = tempfile.mkdtemp(prefix="tr_ckpt_", dir=ROOT / "build")
    try:
        free = shutil.disk_usage(ck_dir).free
        if free < 2 * n_bytes:
            raise AssertionError(
                f"path TR: TR4 needs {2 * n_bytes / 1e9:.1f} GB free under "
                f"{ck_dir} for a {n_bytes / 1e9:.2f} GB checkpoint; "
                f"{free / 1e9:.1f} GB are free")
        mgr = CheckpointManager(ck_dir, keep_last=1)
        extra = {"data": ds.state(k)}
        before = ds.batch(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save_async(k, state, extra=extra)
        t_copy = time.perf_counter() - t0
        nxt, _ = step(state, before)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0 - t_copy
        mgr.wait()
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, got_step, got_extra = mgr.restore(state, device=DEVICE)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        restored = tr_leaves(back)
        bad = [n for n, t in leaves.items()
               if restored[n].device.type != torch.device(DEVICE).type
               or not torch.equal(restored[n], t)]
        d = got_extra["data"]
        replay = SyntheticLM(ds.cfg, ds.seq_len, ds.global_batch,
                             seed=d["seed"], mode=d["mode"],
                             device=DEVICE).batch(d["step"])
        replay_ok = all(torch.equal(replay[n], before[n]) for n in before)
        print(f"TR4: {len(leaves)} leaves, {n_bytes / 1e9:.3f} GB; "
              f"save_async: host copy {t_copy:.2f} s, the next step beside "
              f"the writer {t_step:.2f} s, written in {t_save:.2f} s; "
              f"restored onto {DEVICE} in {t_restore:.2f} s; every leaf "
              f"equal: {not bad}; step {got_step} and extra equal: "
              f"{got_step == k and got_extra == extra}; ds.batch({k}) "
              f"replayed equal: {replay_ok}", flush=True)
        if bad or got_step != k or got_extra != extra or not replay_ok:
            raise AssertionError(f"path TR: TR4 failed {bad[:4]}")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    return nxt, n_bytes / 1e9, t_save, t_restore


def path_tr(torch, args, kern_fused) -> dict:
    """Path TR: training qwen1.5-4b at its published width (d 2560, vocab
    151936), weights from a seed, depth cut to ``--layers``, bf16
    activations over fp32 master parameters, remat on (the config's),
    ``SHAPES["train_4k"]``'s 4096 positions with the global batch cut from
    256 to 2 in 2 microbatches, ``cosine_schedule(3e-4, 2, 8)``, clip 1.0,
    weight decay 0.1, ``SyntheticLM(mode="lm", seed=0)``; each step
    through ``resilient_step`` and a ``StragglerMonitor``, as
    ``examples/train_lm.py`` drives them.  Gates, each raising on failure:
    TR1. four steps with finite losses and grad norms; a fifth on step 4's
         batch gives a loss below step 4's + 1e-3;
    TR2. microbatches 2 against 1 (``tr2_microbatches``);
    TR3. remat on against off (``tr3_remat``);
    TR4. an asynchronous checkpoint round trip (``tr4_checkpoint``);
    TR5. no kernel of ``csrc/`` launches in TR, and no JAX is loaded.
    Printed: step time (median of steps 2-4, each timed to a
    synchronize), tokens/s, the AdamW update alone, peak memory, the
    checkpoint's GB and seconds, stragglers flagged."""
    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.runtime import StragglerMonitor, resilient_step
    from repro_torch.train import step as TS

    t_tr = time.perf_counter()
    kern_fused.reset_launch_counts()
    shape = SHAPES["train_4k"]
    base = get_config("qwen1.5-4b")
    cfg = dataclasses.replace(base, n_layers=args.layers)
    print(f"path TR: {cfg.name} at published width d={cfg.d_model} "
          f"vocab={cfg.vocab} dtype={cfg.dtype} remat={cfg.remat}; depth "
          f"cut to {cfg.n_layers} of {base.n_layers} layers; "
          f"{shape.name}'s {shape.seq_len} positions, global batch "
          f"{shape.global_batch} cut to {TR_BATCH} in {TR_MICRO} "
          f"microbatches; weights from seed {SEED}", flush=True)
    torch.cuda.empty_cache()
    tr2_microbatches(torch, base, shape)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    state = TS.make_train_state(cfg, SEED, device=DEVICE)
    n_params = sum(t.numel() for t in tr_leaves(state.params).values())
    ds = SyntheticLM(cfg, shape.seq_len, TR_BATCH, seed=0, mode="lm",
                     device=DEVICE)
    step = tr_step_fn(cfg, TR_MICRO)
    mon = StragglerMonitor()
    metrics, times = [], []
    for i in range(TR_STEPS + 1):
        k = min(i, TR_STEPS - 1)           # the fifth repeats step 4's batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = resilient_step(step, state, ds.batch(k))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        mon.record(dt)
        metrics.append({n: float(v) for n, v in m.items()})
        times.append(dt)
        print(f"TR step {i + 1} (batch {k}): loss {metrics[-1]['loss']:.5f} "
              f"grad norm {metrics[-1]['grad_norm']:.5f} lr "
              f"{metrics[-1]['lr']:.3e} in {dt:.3f} s", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                 for m in metrics)
    l4, l5 = metrics[TR_STEPS - 1]["loss"], metrics[TR_STEPS]["loss"]
    print(f"TR1: losses and grad norms finite: {finite}; step 5 on step 4's "
          f"batch: loss {l5:.5f} < {l4:.5f} + 1e-3: {l5 < l4 + 1e-3}",
          flush=True)
    if not finite or not l5 < l4 + 1e-3:
        raise AssertionError("path TR: TR1 failed")
    step_s = sorted(times[1:TR_STEPS])[1]
    tokens = TR_BATCH * shape.seq_len

    # the AdamW update alone (the moments stand in for the gradients)
    upd = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = adamw.update(state.opt.mu, state.opt, state.params, lr=1e-4)
        torch.cuda.synchronize()
        upd.append(time.perf_counter() - t0)
        del out
    update_s = sorted(upd)[1]
    torch.cuda.empty_cache()

    tr3_remat(torch, cfg, state, ds.batch(TR_STEPS))
    torch.cuda.empty_cache()
    state, ck_gb, save_s, restore_s = tr4_checkpoint(
        torch, step, state, ds, TR_STEPS + 1)
    del state
    torch.cuda.empty_cache()

    moved = {n: c for n, c in kern_fused.LAUNCHES.items() if c}
    jax_loaded = sorted(n for n in sys.modules
                        if n == "jax" or n.startswith("jax."))
    print(f"TR5: kernel launches in TR: {moved or 'none'}; JAX modules "
          f"loaded: {jax_loaded or 'none'}", flush=True)
    if moved or jax_loaded:
        raise AssertionError("path TR: TR5 failed")
    print(f"path TR ({n_params / 1e9:.4f} G parameters, {cfg.n_layers} "
          f"layers, {tokens} tokens a step): step {step_s:.3f} s (median of "
          f"steps 2-{TR_STEPS}), {tokens / step_s:.0f} tokens/s; AdamW "
          f"update {update_s * 1e3:.1f} ms; peak memory {peak:.2f} GiB; "
          f"checkpoint {ck_gb:.3f} GB saved in {save_s:.2f} s, restored in "
          f"{restore_s:.2f} s; stragglers flagged {len(mon.flagged)}; path "
          f"TR in {time.perf_counter() - t_tr:.1f} s", flush=True)
    return {"step_s": step_s, "tokens_s": tokens / step_s,
            "update_s": update_s, "peak": peak, "ck_gb": ck_gb,
            "save_s": save_s, "restore_s": restore_s,
            "stragglers": len(mon.flagged)}


SO_STEPS = 2                   # SO1's train steps (TR's two microbatches)
SO_ROWS, SO_PROMPT, SO_NEW = 4, 32, 8   # SO2's rows, prompt, decode steps
#: the meshes of SO's printed per-device bytes of TR's 40-layer state
SO_MESHES = (((8, 1), ("data", "model")), ((2, 4), ("data", "model")),
             ((16, 16), ("data", "model")))


def so_state_bytes(base) -> dict:
    """Per-device bytes of ``base``'s whole train state (fp32 params, mu,
    nu, and one fp32 gradient like the params) on each of ``SO_MESHES``,
    from the rules' local shard shapes: arithmetic on meta tensors, no
    allocation.  Returns {mesh: {part: GB}}."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.pytree import flatten_with_path
    from repro_torch.sharding import rules
    from repro_torch.train import step as TS

    state = TS.make_train_state(base, SEED, device="meta")
    leaves = dict(flatten_with_path(state))
    out = {}
    for sizes, names in SO_MESHES:
        mesh = MeshShape(names, sizes)
        specs = rules.spec_leaves(
            rules.opt_state_shardings(base, state, mesh), state)

        def local_bytes(name):
            t = leaves[name]
            return (math.prod(rules.local_shape(t.shape, specs[name], mesh))
                    * t.element_size())

        parts = {k: sum(local_bytes(n) for n in leaves
                        if n.startswith(prefix)) / 1e9
                 for k, prefix in (("params", "params/"), ("mu", "opt/mu/"),
                                   ("nu", "opt/nu/"))}
        parts["grads"] = parts["params"]
        parts["total"] = sum(parts.values())
        out["x".join(map(str, sizes))] = parts
    return out


def so_equal(torch, got: dict, want: dict) -> list:
    """Names of the leaves of ``got`` (DTensors on the card) that are not
    ``torch.equal`` to ``want`` (host tensors)."""
    return [n for n, t in got.items()
            if not torch.equal(t.full_tensor(), want[n].to(DEVICE))]


def path_so(torch, args, kern_fused) -> dict:
    """Path SO: scale-out on one card.  The port's sharded steps
    (``repro_torch.launch.steps``) on a one-rank NCCL group and a (1, 1)
    ``("data", "model")`` mesh, qwen1.5-4b at its published width, depth
    cut to ``--layers``, weights from a seed, held against the unsharded
    path.  One card cannot run what exists only across ranks (NCCL takes
    one rank per device); multi-rank numerics are held on a gloo mesh on
    the CPU (``tests/test_torch_distribution.py``).  Gates, each raising:
    SO0. the group and mesh open (``dist.HashStore``, ``device_id``) and
         close at the end;
    SO1. ``build_train_step`` over TR's two microbatches of 2 x 4096
         tokens, two steps, against the unsharded ``train_step_fn`` from
         the same seed (its state moved to the host first): loss, grad
         norm and every parameter and moment ``torch.equal``;
    SO2. ``build_prefill`` (4 rows x 32 positions) and ``build_decode``
         (8 greedy steps) against ``prefill`` and ``decode_step``: logits
         every step and the caches ``torch.equal``;
    SO3. every placement SO1 and SO2 returned equals ``to_placements`` of
         the rules' spec on the mesh; no kernel of ``csrc/`` launched and
         no JAX loaded.
    Printed: the sharded and unsharded step times (DTensor's dispatch
    cost; the second step of each, each timed to a synchronize), peak
    memory, and the per-device bytes of TR's whole 40-layer state on
    the (8,1), (2,4) and (16,16) meshes (``so_state_bytes``)."""
    import torch.distributed as dist

    from repro_torch.config import SHAPES, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules
    from repro_torch.train import step as TS

    t_so = time.perf_counter()
    kern_fused.reset_launch_counts()
    base = get_config("qwen1.5-4b")
    cfg = dataclasses.replace(base, n_layers=args.layers)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TR_BATCH)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device(DEVICE, 0))
    try:
        mesh = make_debug_mesh(1, 1, DEVICE)
        print(f"SO0: one-rank {dist.get_backend()} group, mesh "
              f"{tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}; {cfg.name} "
              f"at published width, {cfg.n_layers} of {base.n_layers} "
              f"layers, weights from seed {SEED}", flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ds = SyntheticLM(cfg, shape.seq_len, TR_BATCH, seed=0, mode="lm",
                         device=DEVICE)
        batches = [ds.batch(k) for k in range(SO_STEPS)]

        def run(step, state):
            ms, secs = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, b)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                ms.append(m)
            return state, ms, secs

        # SO1: the unsharded reference first, moved to the host
        ref, ref_m, ref_s = run(tr_step_fn(cfg, TR_MICRO),
                                TS.make_train_state(cfg, SEED, device=DEVICE))
        ref = {n: t.cpu() for n, t in tr_leaves(ref).items()}
        ref_m = [{k: v.cpu() for k, v in m.items()} for m in ref_m]
        torch.cuda.empty_cache()
        fn, (state_struct, _) = ST.build_train_step(
            cfg, mesh, shape, microbatches=TR_MICRO, max_grad_norm=1.0,
            weight_decay=0.1,
            lr_schedule=adamw.cosine_schedule(TR_LR, TR_WARMUP, TR_TOTAL))
        got, got_m, got_s = run(fn, TS.make_train_state(cfg, SEED,
                                                        device=DEVICE))
        metrics_eq = all(torch.equal(g[k].full_tensor().cpu(), w[k])
                         for g, w in zip(got_m, ref_m)
                         for k in ("loss", "grad_norm", "lr"))
        got_leaves = tr_leaves(got)
        bad = so_equal(torch, got_leaves, ref)
        state_sh = rules.opt_state_shardings(cfg, state_struct, mesh)
        placed = so_placed(torch, got, state_sh, mesh)
        print(f"SO1: build_train_step, {SO_STEPS} steps of {TR_BATCH} x "
              f"{shape.seq_len} tokens in {TR_MICRO} microbatches: losses "
              f"{[float(m['loss']) for m in ref_m]} grad norms "
              f"{[float(m['grad_norm']) for m in ref_m]}; loss, grad norm "
              f"and lr equal: {metrics_eq}; {len(got_leaves)} leaves "
              f"(params, mu, nu, step) torch.equal: {not bad}", flush=True)
        if not metrics_eq or bad:
            raise AssertionError(f"path SO: SO1 failed {bad[:4]}")
        step_s, ref_step_s = got_s[-1], ref_s[-1]
        del got, got_leaves, ref
        torch.cuda.empty_cache()

        # SO2: prefill and greedy decode
        api = get_model(cfg)
        params = api.init_params(cfg, SEED, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
        prompts = torch.randint(0, cfg.vocab, (SO_ROWS, SO_PROMPT),
                                generator=gen, device=DEVICE)
        max_len = SO_PROMPT + SO_NEW
        pre, _ = ST.build_prefill(cfg, mesh, ShapeConfig(
            "so_prefill", max_len, SO_ROWS, "prefill"))
        dec, _ = ST.build_decode(cfg, mesh, ShapeConfig(
            "so_decode", max_len, SO_ROWS, "decode"))
        l_ref, c_ref = api.prefill(cfg, params, prompts, max_len)
        l_got, c_got = pre(params, {"tokens": prompts})
        logits_eq = [torch.equal(l_got.full_tensor(), l_ref)]
        c_got_leaves = tr_leaves(c_got)
        cache_sh = rules.tree_cache_shardings(cfg, c_got, mesh)
        placed = placed and so_placed(torch, c_got, cache_sh, mesh)
        tok_ref = tok_got = l_ref[:, -1].argmax(-1)[:, None]
        for _ in range(SO_NEW):
            l_ref, c_ref = api.decode_step(cfg, params, tok_ref, c_ref)
            l_got, c_got = dec(params, {"token": tok_got, "cache": c_got})
            logits_eq.append(torch.equal(l_got.full_tensor(), l_ref))
            tok_ref = l_ref[:, -1].argmax(-1)[:, None]
            tok_got = l_got.full_tensor()[:, -1].argmax(-1)[:, None]
        placed = placed and so_placed(
            torch, c_got, rules.tree_cache_shardings(cfg, c_got, mesh), mesh)
        c_bad = so_equal(torch, tr_leaves(c_got),
                         {n: t.cpu() for n, t in tr_leaves(c_ref).items()})
        print(f"SO2: build_prefill {SO_ROWS} x {SO_PROMPT} and "
              f"build_decode x {SO_NEW}: logits torch.equal at every step: "
              f"{all(logits_eq)} ({sum(logits_eq)}/{len(logits_eq)}); "
              f"{len(c_got_leaves)} cache leaves torch.equal: {not c_bad}",
              flush=True)
        if not all(logits_eq) or c_bad:
            raise AssertionError(f"path SO: SO2 failed {c_bad[:4]}")
        del params, c_ref, c_got, l_ref, l_got
        peak = torch.cuda.max_memory_allocated() / 2**30

        moved = {n: c for n, c in kern_fused.LAUNCHES.items() if c}
        jax_loaded = sorted(n for n in sys.modules
                            if n == "jax" or n.startswith("jax."))
        print(f"SO3: every returned placement equals the rules' on the "
              f"(1, 1) mesh: {placed}; kernel launches in SO: "
              f"{moved or 'none'}; JAX modules loaded: "
              f"{jax_loaded or 'none'}", flush=True)
        if not placed or moved or jax_loaded:
            raise AssertionError("path SO: SO3 failed")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    per_dev = so_state_bytes(base)
    print("SO: per-device GB of " + cfg.name + "'s whole "
          f"{base.n_layers}-layer train state (fp32 params, mu, nu, grads) "
          "by the rules: " + "; ".join(
              f"({m}) " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              for m, parts in per_dev.items()), flush=True)
    print(f"path SO: sharded step {step_s:.3f} s vs unsharded "
          f"{ref_step_s:.3f} s (second step of each), peak memory "
          f"{peak:.2f} GiB; path SO in {time.perf_counter() - t_so:.1f} s",
          flush=True)
    return {"step_s": step_s, "ref_step_s": ref_step_s, "peak": peak,
            "per_device": per_dev}


def so_placed(torch, tree, specs, mesh) -> bool:
    """Every leaf of ``tree`` is a DTensor at ``to_placements`` of its
    spec in ``specs`` (a spec tree shaped like it) on ``mesh``."""
    from repro_torch.pytree import flatten_with_path
    from repro_torch.sharding import rules

    want = rules.spec_leaves(specs, tree)
    return all(tuple(x.placements) == rules.to_placements(want[n], mesh)
               for n, x in flatten_with_path(tree))


#: DR1's cells: (arch, shape, the two-pod mesh)
DR_CELLS = (("qwen1.5-4b", "train_4k", False),
            ("qwen1.5-4b", "decode_32k", False),
            ("rwkv6-3b", "prefill_32k", False),
            ("qwen1.5-4b", "decode_32k", True))
#: DR1's meshes: the 16 x 16 production pod and the 2 x 16 x 16 two pods
DR_MESHES = {False: (("data", "model"), (16, 16)),
             True: (("pod", "data", "model"), (2, 16, 16))}
DR_USEFUL = (0.05, 1.0)           # DR1's open-closed bounds on useful_ratio
#: DR3's cell (arch, shape, layers) on the 16 x 16 pod: the MoE combine's
#: Shard->Shard redistributions at published width
DR3_CELL = ("qwen3-moe-235b-a22b", "prefill_32k", 1)
DR_HBM_REL = 0.01                 # DR2: card bytes against the dry-run's
#: DR3's cell counted on the CPU build of torch 2.13 (the tests' torch):
#: collective bytes per device; both meshes here within DR_REL of it
DR3_COLL = 38930847847.5
DR_REL = 1.05                     # DR3, DR4: collective bytes against those
#: DR4's meshes: the tests' (2, 4) smoke mesh, and 1 x 1 for train
DR4_MESHES = {"2x4": (2, 4), "1x1": (1, 1)}
DR4_KINDS = ("train", "prefill", "decode")
DR4_MOE = ("arctic-480b", "qwen3-moe-235b-a22b")
#: DR4's cells counted on the CPU build of torch 2.13 (the tests' torch,
#: ``tests/test_torch_dryrun.py``'s ``PORT_BODY``): {"arch|kind|mesh":
#: (flops per device, collective bytes per device)}
DR4_HERE = {
    "arctic-480b|train|1x1": (574095360, 0.0),
    "gemma-2b|train|1x1": (132120576, 0.0),
    "gemma3-1b|train|1x1": (173015040, 0.0),
    "internvl2-26b|train|1x1": (119537664, 0.0),
    "qwen1.5-4b|train|1x1": (132120576, 0.0),
    "qwen3-14b|train|1x1": (119537664, 0.0),
    "qwen3-moe-235b-a22b|train|1x1": (769916928, 0.0),
    "rwkv6-3b|train|1x1": (160432128, 0.0),
    "whisper-large-v3|train|1x1": (171704320, 0.0),
    "zamba2-7b|train|1x1": (255983616, 0.0),
    "arctic-480b|train|2x4": (71761920, 5708072.0),
    "arctic-480b|prefill|2x4": (23412736, 1902728.0),
    "arctic-480b|decode|2x4": (747520, 93800.0),
    "gemma-2b|train|2x4": (16515072, 1162776.0),
    "gemma-2b|prefill|2x4": (4997120, 314880.0),
    "gemma-2b|decode|2x4": (172032, 45728.0),
    "gemma3-1b|train|2x4": (21626880, 2019352.0),
    "gemma3-1b|prefill|2x4": (6701056, 621056.0),
    "gemma3-1b|decode|2x4": (225280, 62144.0),
    "internvl2-26b|train|2x4": (14942208, 1216024.0),
    "internvl2-26b|prefill|2x4": (4472832, 335360.0),
    "internvl2-26b|decode|2x4": (155648, 44192.0),
    "qwen1.5-4b|train|2x4": (16515072, 1089816.0),
    "qwen1.5-4b|prefill|2x4": (4997120, 290304.0),
    "qwen1.5-4b|decode|2x4": (172032, 41760.0),
    "qwen3-14b|train|2x4": (14942208, 1212824.0),
    "qwen3-14b|prefill|2x4": (4472832, 335360.0),
    "qwen3-14b|decode|2x4": (155648, 44192.0),
    "qwen3-moe-235b-a22b|train|2x4": (96239616, 7860208.0),
    "qwen3-moe-235b-a22b|prefill|2x4": (31571968, 2649548.0),
    "qwen3-moe-235b-a22b|decode|2x4": (1002496, 111116.0),
    "rwkv6-3b|train|2x4": (20054016, 3106456.0),
    "rwkv6-3b|prefill|2x4": (6307840, 900632.0),
    "rwkv6-3b|decode|2x4": (200704, 173160.0),
    "whisper-large-v3|train|2x4": (21463040, 1760280.0),
    "whisper-large-v3|prefill|2x4": (6668288, 509440.0),
    "whisper-large-v3|decode|2x4": (184320, 44320.0),
    "zamba2-7b|train|2x4": (31997952, 3355568.0),
    "zamba2-7b|prefill|2x4": (10321920, 1548160.0),
    "zamba2-7b|decode|2x4": (312832, 100360.0),
}
DR4_JOB = """
import json, math, sys, time
sys.path.insert(0, "src")
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.config import ShapeConfig
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import dryrun
t0 = time.perf_counter()
out = {{}}
for name, dims in {meshes!r}.items():
    kinds = {kinds!r} if name != "1x1" else ("train",)
    with dryrun.fake_group(math.prod(dims)):
        mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
        for arch in ARCH_IDS:
            for kind in kinds:
                key = f"{{arch}}|{{kind}}|{{name}}"
                try:
                    r = dryrun.cell_stats(
                        get_smoke_config(arch), ShapeConfig(kind, 32, 8, kind),
                        mesh, microbatches=2 if kind == "train" else None)
                    out[key] = {{"flops": r["flops_per_device"],
                                "coll": r["total_collective_bytes"],
                                "counts": r["collective_counts"]}}
                except Exception as e:   # a cell that raises fails DR4
                    err = f"{{type(e).__name__}}: {{e}}"
                    out[key] = {{"error": err[:500]}}
print("RECORD " + json.dumps({{"cells": out,
                              "job_s": time.perf_counter() - t0}}), flush=True)
"""
#: DR4v's archs: their sharded steps against the unsharded ones on a
#: (2, 2) gloo mesh of 4 CPU ranks (``repro_torch.launch.gloo_jobs``)
DR4V_ARCHS = ("zamba2-7b", "whisper-large-v3", "arctic-480b")
DR4V_RANKS = 8                    # DR4v's processes at once
DR_JOB = """
import dataclasses, json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, "src")
from repro_torch.config import SHAPES
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_debug_mesh
arch, shape, layers = {arch!r}, {shape!r}, {layers!r}
if layers is None:
    rec = D.run_cell(arch, shape, multi_pod={multi!r})
else:
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    shape = dataclasses.replace(SHAPES[shape], global_batch={batch})
    with D.fake_group(1):
        rec = D.cell_stats(cfg, shape, make_debug_mesh(1, 1, "cpu"),
                           microbatches={micro})
rec["job_s"] = time.perf_counter() - t0
print("RECORD " + json.dumps(rec), flush=True)
"""


DR3_JOB = """
import contextlib, dataclasses, json, sys, time
from unittest import mock
sys.path.insert(0, "src")
from repro_torch.config import SHAPES
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
cfg = dataclasses.replace(get_config({arch!r}), n_layers={layers!r})
out = {{}}
# the cuda mesh sends DTensor's own NCCL branch, with no hook; the cpu
# mesh is counted with the dry-run's hook and, for comparison, without it
for label, device_type, hook in (("cuda", "cuda", False),
                                 ("cpu", "cpu", True),
                                 ("cpu, no hook", "cpu", False)):
    t0 = time.perf_counter()
    own = (contextlib.nullcontext() if hook else
           mock.patch.object(D, "card_alltoall", contextlib.nullcontext))
    with own, D.fake_group(256):
        mesh = make_production_mesh(device_type=device_type)
        rec = D.cell_stats(cfg, SHAPES[{shape!r}], mesh)
    rec["job_s"] = time.perf_counter() - t0
    out[label] = rec
print("RECORD " + json.dumps(out), flush=True)
"""


def dr4_job() -> tuple:
    """Start DR4's smoke cells in one ``python3`` process with no card
    visible.  Returns (Popen, log path)."""
    import os

    out = ROOT / "build" / "dr"
    out.mkdir(parents=True, exist_ok=True)
    log = out / "DR4.log"
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             DR4_JOB.format(meshes=DR4_MESHES, kinds=DR4_KINDS)],
            cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            stdout=fh, stderr=subprocess.STDOUT)
    return proc, log


def dr4_start() -> dict:
    """Start DR4 and DR4v, which touch no device, on the CPU with no card
    visible: DR4's smoke cells in one ``python3`` process
    (:func:`dr4_job`), DR4v's gloo jobs (``repro_torch.launch.gloo_jobs``,
    4 ranks each, at most ``DR4V_RANKS`` processes at once) on threads
    of this one.  The main path starts them first, so that they run
    beside the card's phases.  Returns {"DR4": (Popen, log path),
    "DR4v": Runner}."""
    from repro_torch.launch import gloo_jobs

    job = dr4_job()
    runner = gloo_jobs.Runner(
        [gloo_jobs.Job(f"DR4v {arch}", gloo_jobs.arch_body(arch), 4, 400,
                       env={"CUDA_VISIBLE_DEVICES": ""})
         for arch in DR4V_ARCHS], DR4V_RANKS)
    return {"DR4": job, "DR4v": runner}


def dr_stop(jobs: dict) -> None:
    """Stop every process of phase DR still alive (``dr_start``'s and
    ``dr4_start``'s)."""
    for label, job in jobs.items():
        if label == "DR4v":
            job.stop()
        elif job[0].poll() is None:
            job[0].kill()
            job[0].wait()


def dr_start(layers: int, early=None) -> dict:
    """Start phase DR's CPU halves, each its own ``python3`` process with
    no card visible (the dry-run touches no device; its fake process
    group cannot share a process with SO's NCCL group): DR1's four cells
    at full width on the 16 x 16 fake pod or the 2 x 16 x 16 two pods,
    and DR2's dry-run of TR's reduced cell on a 1 x 1 fake mesh; and DR3,
    the one job that sees the card, ``DR3_CELL`` counted on a fake group
    over a ``cuda`` mesh and over the dry-run's ``cpu`` mesh, with its
    all-to-all hook and without (fake tensors allocate nothing on the
    card).  They run beside TR and SO, which are bound by the card.
    DR4 and DR4v are ``early``'s (``dr4_start``'s), or started here.
    Returns {label: (Popen, log path)}, and DR4v's runner."""
    import os

    procs = dict(early if early is not None else dr4_start())
    out = ROOT / "build" / "dr"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    jobs = {dr_label(*cell): (*cell, None) for cell in DR_CELLS}
    jobs["DR2 dry-run"] = ("qwen1.5-4b", "train_4k", False, layers)
    for label, (arch, shape, multi, n) in jobs.items():
        log = out / (label.replace(" ", "_") + ".log")
        code = DR_JOB.format(arch=arch, shape=shape, multi=multi, layers=n,
                             batch=TR_BATCH, micro=TR_MICRO)
        with open(log, "w") as fh:
            procs[label] = (subprocess.Popen(
                [sys.executable, "-c", code], cwd=ROOT, env=env, stdout=fh,
                stderr=subprocess.STDOUT), log)
    arch, shape, n = DR3_CELL
    log = out / "DR3.log"
    with open(log, "w") as fh:
        procs["DR3"] = (subprocess.Popen(
            [sys.executable, "-c",
             DR3_JOB.format(arch=arch, shape=shape, layers=n)],
            cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT), log)
    return procs


def dr_label(arch: str, shape: str, multi: bool) -> str:
    return f"DR1 {arch} x {shape} x {'pod2x16x16' if multi else 'pod16x16'}"


def dr_record(label: str, job) -> dict:
    """Wait for one of ``dr_start``'s jobs; its record, or raise with the
    end of its log."""
    proc, log = job
    rc = proc.wait()
    text = log.read_text()
    lines = [ln for ln in text.splitlines() if ln.startswith("RECORD ")]
    if rc != 0 or not lines:
        raise AssertionError(f"phase DR: {label} exited {rc}:\n"
                             f"{text[-3000:]}")
    return json.loads(lines[-1][len("RECORD "):])


def dr_arg_bytes(cfg, shape, mesh) -> int:
    """Rank 0's bytes of a cell's placed inputs from the rules' specs and
    ``rules.local_shape`` on a ``MeshShape`` (arithmetic on meta tensors,
    independent of DTensor's own split)."""
    from repro_torch.launch import steps as ST
    from repro_torch.models.registry import get_model
    from repro_torch.pytree import flatten_with_path
    from repro_torch.sharding import rules
    from repro_torch.train import step as TS

    first = (TS.make_train_state(cfg, 0, device="meta")
             if shape.kind == "train"
             else get_model(cfg).init_params(cfg, 0, device="meta"))
    structs = (first, ST.input_specs(cfg, shape))
    total = 0
    for tree, specs in zip(structs, ST.input_shardings(
            cfg, mesh, shape.kind, structs)):
        want = rules.spec_leaves(specs, tree)
        total += sum(math.prod(rules.local_shape(t.shape, want[n], mesh))
                     * t.element_size()
                     for n, t in flatten_with_path(tree))
    return total


def dr3_check(dr3: dict) -> None:
    """DR3's gate on its job's records ({mesh label: record}): the
    ``cuda`` mesh's count (DTensor's NCCL branch) equals the ``cpu``
    mesh's under ``dryrun.card_alltoall`` kind by kind, with all-to-alls
    on both; every record is printed."""
    arch, shape_name, n = DR3_CELL
    keys = ("flops_per_device", "collective_bytes_per_device",
            "collective_counts")
    for label, rec in dr3.items():
        print(f"DR3 {arch} x {shape_name} x pod16x16, {n} layer, "
              f"{label} mesh: flops/device "
              f"{rec['flops_per_device']:.6e}, HBM bytes/device "
              f"{rec['hbm_bytes_per_device']:.6e}; collective bytes/device "
              f"{rec['collective_bytes_per_device']} (total "
              f"{rec['total_collective_bytes']:.6e}), counts "
              f"{rec['collective_counts']}; traced in {rec['trace_s']} s "
              f"({rec['job_s']:.1f} s with its fake group and mesh)",
              flush=True)
    equal = {k: dr3["cuda"][k] == dr3["cpu"][k] for k in keys}
    excess = (dr3["cpu, no hook"]["total_collective_bytes"]
              / dr3["cuda"]["total_collective_bytes"])
    ratio = {m: dr3[m]["total_collective_bytes"] / DR3_COLL
             for m in ("cuda", "cpu")}
    print(f"DR3 cuda mesh == cpu mesh: {equal}; the cpu mesh without the "
          f"hook counts {excess:.4f}x the cuda mesh's collective bytes; "
          f"against torch 2.13's count {DR3_COLL:.6e}: cuda "
          f"{ratio['cuda']:.4f}x, cpu {ratio['cpu']:.4f}x", flush=True)
    if not all(equal.values()) or not all(
            dr3[m]["collective_counts"]["all-to-all"] > 0
            and ratio[m] <= DR_REL and 1 / ratio[m] <= DR_REL
            for m in ("cuda", "cpu")):
        raise AssertionError("phase DR: DR3 failed")


def dr4_check(dr4: dict) -> None:
    """DR4's gates on its job's record: every cell counts (a cell that
    raised fails), each train cell's flops x 8 equal its 1 x 1 flops,
    each cell's flops equal ``DR4_HERE``'s, the MoE train and prefill
    cells count an all-to-all, and no cell's collective bytes exceed
    ``DR_REL`` x ``DR4_HERE``'s.  One line a cell is printed."""
    cells, bad = dr4["cells"], []
    for key in sorted(DR4_HERE, key=lambda k: k.split("|")[::-1]):
        arch, kind, mesh = key.split("|")
        got, (flops, coll) = cells.get(key, {"error": "not counted"}), \
            DR4_HERE[key]
        if "error" in got:
            print(f"DR4 {arch} x {kind} x {mesh}: {got['error']}",
                  flush=True)
            bad.append(key)
            continue
        a2a = int(got["counts"]["all-to-all"])
        ratio = got["coll"] / coll if coll else float(got["coll"] == 0)
        print(f"DR4 {arch} x {kind} x {mesh}: flops/device {got['flops']:.0f}"
              f" (torch 2.13: {flops:.0f}); collective bytes/device "
              f"{got['coll']:.0f} (torch 2.13: {coll:.0f}, {ratio:.4f}x); "
              f"all-to-alls {a2a}", flush=True)
        one = cells.get(f"{arch}|train|1x1", {}).get("flops")
        if (got["flops"] != flops or got["coll"] > DR_REL * coll
                or (kind == "train" and mesh == "2x4"
                    and got["flops"] * 8 != one)
                or (arch in DR4_MOE and kind != "decode" and mesh == "2x4"
                    and a2a < 1)):
            bad.append(key)
    print(f"DR4: {len(DR4_HERE) - len(bad)} of {len(DR4_HERE)} cells "
          f"within the gates in {dr4['job_s']:.1f} s", flush=True)
    if bad:
        raise AssertionError(f"phase DR: DR4 failed on {bad}")


def dr4v_check(runner) -> None:
    """DR4v's gate: each arch's sharded train (2 microbatches), prefill
    and decode step within ``gloo_jobs.arch_departures``'s bounds of the
    unsharded step, the bounds of ``tests/test_torch_distribution.py``;
    a job that fails fails the phase.  Its largest differences are
    printed."""
    from repro_torch.launch import gloo_jobs

    bad = []
    for arch in DR4V_ARCHS:
        name = f"DR4v {arch}"
        try:
            res = runner[name]
        except AssertionError as e:
            print(f"{name}: {str(e)[-3000:]}", flush=True)
            bad.append(arch)
            continue
        t, p, d = res["train"], res["prefill"], res["decode"]
        print(f"{name} on a (2, 2) gloo mesh, torch {_torch_version()}: "
              f"train loss rel {t['loss_rel']:.3e}, grad norm rel "
              f"{t['gnorm_rel']:.3e}, worst parameter {t['param_worst']:.3e}"
              f"; prefill logits rel {p['logits_rel']:.3e}, cache rel "
              f"{p['cache_rel']:.3e}; decode logits rel "
              f"{d['logits_rel']:.3e}, cache rel {d['cache_rel']:.3e}; "
              f"tokens equal {p['tokens_equal'] and d['tokens_equal']} "
              f"({runner.jobs[name].seconds:.1f} s)", flush=True)
        if gloo_jobs.arch_departures(res):
            bad.append(arch)
    if bad:
        raise AssertionError(f"phase DR: DR4v failed on {bad}")


def _torch_version() -> str:
    import torch

    return torch.__version__


def path_dr(torch, args, kern_fused, procs) -> dict:
    """Phase DR: the dry-run tooling (``repro_torch.launch.dryrun``,
    ``op_stats``, ``roofline``).  Gates, each raising:
    DR1. qwen1.5-4b x train_4k and x decode_32k and rwkv6-3b x
         prefill_32k (the per-rank recurrence) at full width and depth on
         the 16 x 16 fake pod, and qwen1.5-4b x decode_32k on the 2 x 16
         x 16 two pods (``run_cell``, each in its own process,
         ``dr_start``): no error or skip, 256 or 512 devices,
         ``argument_size_in_bytes`` equal to ``dr_arg_bytes`` and
         ``0.05 < useful_ratio <= 1`` (above 1 work was lost; near 1/256
         global work was counted per device);
    DR2. TR's reduced cell (``--layers``, 2 x 4096 tokens in 2
         microbatches, bf16): its dry-run on a 1 x 1 fake mesh against
         the real ``build_train_step`` on a one-rank NCCL group and a
         (1, 1) mesh on the card, counted by the same ``OpStats``: flops
         equal, HBM bytes within 1%, ``argument_size_in_bytes`` equal to
         the placed inputs' bytes, and the H100 roofline bound no longer
         than the measured step (a bound above it means the count is
         wrong);
    DR3. ``DR3_CELL`` (qwen3-moe-235b-a22b x prefill_32k, 1 layer, full
         width, 16 x 16 fake pod) counted on a ``cuda`` mesh, where
         DTensor takes its own NCCL branch, and on the dry-run's ``cpu``
         mesh, where ``dryrun.card_alltoall`` stands in for DTensor's
         all-gather fallback: flops, collective bytes and collective
         counts equal kind by kind, all-to-alls counted on both, and the
         collective bytes within ``DR_REL`` of ``DR3_COLL`` (a cuda mesh
         that cannot be built fails the phase); the ``cpu`` mesh without
         the hook, DTensor's all-gather fallback, is printed beside
         them;
    DR4. the smoke cells on the card's torch (``dr4_check``);
    DR4v. three archs' sharded steps on its gloo ranks
         (``dr4v_check``).
    Printed: seconds per cell, DR1's per-device collective bytes and
    counts, DR2's roofline fraction and the dry-run's peak estimate
    (arguments + temporaries) beside ``max_memory_allocated``, DR3's two
    records."""
    import torch.distributed as dist

    from repro_torch.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import roofline
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import MeshShape, make_debug_mesh
    from repro_torch.launch.op_stats import OpStats
    from repro_torch.pytree import leaves
    from repro_torch.sharding import rules
    from repro_torch.train import step as TS

    t_dr = time.perf_counter()
    kern_fused.reset_launch_counts()
    base = get_config("qwen1.5-4b")
    runs = {k: v for k, v in procs.items() if k != "DR4v"}
    for proc, _ in runs.values():
        proc.wait()
    recs = {label: dr_record(label, job) for label, job in runs.items()}
    for arch, shape_name, multi in DR_CELLS:
        label = dr_label(arch, shape_name, multi)
        rec = recs[label]
        bad = [k for k in ("error", "skipped") if k in rec]
        if bad:
            raise AssertionError(f"phase DR: {label}: "
                                 f"{rec.get('error') or rec['skipped']}")
        mesh = MeshShape(*DR_MESHES[multi])
        want = dr_arg_bytes(get_config(arch), SHAPES[shape_name], mesh)
        got = rec["memory_analysis"]["argument_size_in_bytes"]
        row = roofline.roofline_row(roofline._enrich(dict(rec)))
        coll = {k: v for k, v in rec["collective_bytes_per_device"].items()
                if v}
        counts = {k: int(v) for k, v in rec["collective_counts"].items()
                  if v}
        print(f"{label}: "
              f"{rec['n_devices']} devices, traced in {rec['trace_s']} s "
              f"({rec['job_s']:.1f} s with its imports); flops/device "
              f"{rec['flops_per_device']:.4e}, HBM bytes/device "
              f"{rec['hbm_bytes_per_device']:.4e}; collective bytes/device "
              f"{coll} (total {rec['total_collective_bytes']:.4e}), counts "
              f"{counts}; memory {rec['memory_analysis']}; arguments "
              f"{got} B, by the rules {want} B; useful_ratio "
              f"{row['useful_ratio']:.4f}; H100 terms compute "
              f"{row['compute_s']:.4e} s, memory {row['memory_s']:.4e} s, "
              f"collective {row['collective_s']:.4e} s ({row['dominant']})",
              flush=True)
        lo, hi = DR_USEFUL
        if (rec["n_devices"] != math.prod(mesh.sizes) or got != want
                or not lo < row["useful_ratio"] <= hi):
            raise AssertionError(f"phase DR: {label} failed")

    dr3_check(recs["DR3"])
    dr4_check(recs["DR4"])
    dr4v_check(procs["DR4v"])

    # DR2: TR's reduced cell, dry-run against the card
    dry = recs["DR2 dry-run"]
    cfg = dataclasses.replace(base, n_layers=args.layers)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TR_BATCH)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(DEVICE, 0))
    try:
        mesh = make_debug_mesh(1, 1, DEVICE)
        fn, structs = ST.build_train_step(cfg, mesh, shape,
                                          microbatches=TR_MICRO)
        specs = ST.input_shardings(cfg, mesh, "train", structs)
        torch.cuda.empty_cache()
        state = TS.make_train_state(cfg, SEED, device=DEVICE)
        batch = SyntheticLM(cfg, shape.seq_len, TR_BATCH, seed=0, mode="lm",
                            device=DEVICE).batch(0)
        placed = tuple(rules.distribute_tree(t, sp, mesh)
                       for t, sp in zip((state, batch), specs))
        del state
        arg_bytes = sum(x.to_local().numel() * x.element_size()
                        for x in leaves(placed))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with OpStats() as stats:
            out = fn(*placed)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del out
        secs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*placed)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            del out
        step_s = secs[-1]
        del placed
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    card = stats.summary()
    rec = dict(dry, arch="qwen1.5-4b", shape="train_4k", mesh="1x1",
               kind="train", params=cfg.param_count(),
               active_params=cfg.active_param_count(),
               seq_len=shape.seq_len, global_batch=shape.global_batch)
    rec = roofline._enrich(rec)
    rec["n_layers"] = cfg.n_layers       # _enrich reads the config's depth
    row = roofline.roofline_row(rec)
    bound_s = max(row["compute_s"], row["memory_s"], row["collective_s"])
    hbm_rel = abs(card.hbm_bytes - dry["hbm_bytes_per_device"]) \
        / dry["hbm_bytes_per_device"]
    est = (dry["memory_analysis"]["argument_size_in_bytes"]
           + dry["memory_analysis"]["temp_size_in_bytes"])
    moved = {n: c for n, c in kern_fused.LAUNCHES.items() if c}
    print(f"DR2 {cfg.name} {cfg.n_layers} layers, {TR_BATCH} x "
          f"{shape.seq_len} tokens in {TR_MICRO} microbatches: flops "
          f"dry-run {dry['flops_per_device']:.6e} card {card.flops:.6e} "
          f"(equal: {card.flops == dry['flops_per_device']}); HBM bytes "
          f"dry-run {dry['hbm_bytes_per_device']:.6e} card "
          f"{card.hbm_bytes:.6e} (rel {hbm_rel:.2e}); arguments dry-run "
          f"{dry['memory_analysis']['argument_size_in_bytes']} B, placed on "
          f"the card {arg_bytes} B; H100 roofline bound {bound_s:.4f} s "
          f"({row['dominant']}: compute {row['compute_s']:.4f}, memory "
          f"{row['memory_s']:.4f}) against the measured step {step_s:.4f} s"
          f" (bound / step {bound_s / step_s:.3f}; roofline_fraction "
          f"{row['roofline_fraction']:.3f}; model flops at peak over the "
          f"step {row['model_flops'] / roofline.H100.peak_flops / step_s:.3f}"
          f"); peak memory estimated {est / 2**30:.2f} GiB, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; dry-run "
          f"{dry['job_s']:.1f} s; kernel launches {moved or 'none'}",
          flush=True)
    if (card.flops != dry["flops_per_device"] or hbm_rel > DR_HBM_REL
            or arg_bytes != dry["memory_analysis"]["argument_size_in_bytes"]
            or bound_s > step_s):
        raise AssertionError("phase DR: DR2 failed")
    print(f"phase DR in {time.perf_counter() - t_dr:.1f} s (its CPU "
          f"halves began before path TR)", flush=True)
    return {"step_s": step_s, "bound_s": bound_s, "recs": recs}


# ---------------------------------------------------------------------------
# phase EX: the examples, the port's entry points
# ---------------------------------------------------------------------------

EX_STEPS = 300        # train_lm's steps (its default)


def ex_run(torch, kern_fused, name: str, argv: list):
    """Run ``repro_torch.examples.<name>.main(argv)`` on the card with
    every launch count at 0, its printed lines echoed under its name;
    returns (what main returned, its text, seconds, launches)."""
    import importlib
    import io

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    kern_fused.reset_launch_counts()
    buf = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv + ["--device", DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(kern_fused.LAUNCHES)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"EX {name} | {line}")
    print(f"EX {name}: {secs:.1f} s, kernels.fused.LAUNCHES {launches}",
          flush=True)
    return out, text, secs, launches


def finite(*xs) -> bool:
    return all(math.isfinite(float(x)) for x in xs)


def phase_ex(torch, kern_fused) -> dict:
    """Phase EX: the six examples (``repro_torch.examples``), each
    ``main`` on the card; gates in the module docstring, item 15, each
    raising.  Returns {example: launches} and train_lm's numbers."""
    import shutil

    t_ex = time.perf_counter()
    # the examples' own scratch (trained MLP, sweep cache) and train_lm's
    # checkpoints start empty: everything is computed on this card
    for d in (ROOT / "build" / "examples", ROOT / "build" / "ex"):
        shutil.rmtree(d, ignore_errors=True)
    ckpt = str(ROOT / "build" / "ex" / "train_lm")
    launches = {}

    errs, _, _, launches["quickstart"] = ex_run(
        torch, kern_fused, "quickstart", [])
    if not (finite(*(e for _, e in errs)) and errs[0][1] < errs[1][1]):
        raise AssertionError(f"phase EX: quickstart {errs}")

    out, _, _, launches["hetero_profile"] = ex_run(
        torch, kern_fused, "hetero_profile", [])
    if (out["pack"].head is not None
            or len(out["energy"]) != len(out["pack"].layer_weights)
            or not finite(*out["losses"])):
        raise AssertionError("phase EX: hetero_profile")
    del out

    out, _, _, launches["analog_serve"] = ex_run(
        torch, kern_fused, "analog_serve", [])
    if (len(out["losses"]) != 3
            or not finite(out["digital"], out["agreement"],
                          *out["losses"].values())):
        raise AssertionError(f"phase EX: analog_serve {out}")

    out, _, _, launches["serve_loop"] = ex_run(
        torch, kern_fused, "serve_loop", [])
    done = out["completions"]
    if (len(done) != 10 or sorted(c.uid for c in done) != list(range(10))
            or out["stats"]["tokens_out"] != sum(len(c.tokens)
                                                 for c in done)):
        raise AssertionError(f"phase EX: serve_loop {out['stats']}")

    out, _, _, launches["design_space"] = ex_run(
        torch, kern_fused, "design_space", [])
    if len(out["rows"]) != 5 or not finite(
            out["digital"], *(v for r in out["rows"] for v in r[1:])):
        raise AssertionError(f"phase EX: design_space {out}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold on the card, inside the peak below
    held = torch.cuda.memory_allocated() / 2 ** 30
    out, _, tl_s, launches["train_lm"] = ex_run(
        torch, kern_fused, "train_lm", ["--steps", str(EX_STEPS),
                                        "--ckpt-dir", ckpt])
    losses = out["losses"]
    if (len(losses) != EX_STEPS or out["start"] != 0
            or not finite(*losses) or not losses[-1] < losses[0]
            or out["kept"] != [200, 300]):
        raise AssertionError(f"phase EX: train_lm {len(losses)} steps, "
                             f"first {losses[:1]}, last {losses[-1:]}, "
                             f"kept {out['kept']}")
    step_s = sorted(out["step_s"])[len(out["step_s"]) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    again, text, _, _ = ex_run(torch, kern_fused, "train_lm",
                               ["--steps", str(EX_STEPS), "--ckpt-dir",
                                ckpt])
    if ("resumed from step 300" not in text.splitlines()
            or again["losses"] or again["start"] != EX_STEPS):
        raise AssertionError("phase EX: train_lm did not resume at 300")
    print(f"phase EX: train_lm {EX_STEPS} steps in {tl_s:.1f} s, median "
          f"step {step_s * 1e3:.2f} ms, {16 * 128 / step_s:.0f} tokens/s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, peak {peak:.2f} GiB "
          f"({held:.2f} GiB of it held by earlier phases before train_lm "
          f"started, {peak - held:.2f} GiB train_lm's own); "
          f"phase EX in {time.perf_counter() - t_ex:.1f} s", flush=True)
    return {"launches": launches, "step_s": step_s, "peak": peak,
            "held": held, "seconds": time.perf_counter() - t_ex}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4,
                    help="depth of qwen1.5-4b to serve (1..40, default 4)")
    args = ap.parse_args()
    if not 1 <= args.layers <= 40:
        ap.error("--layers takes 1..40")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import build

    card = card_line()
    print(f"card: {card}", flush=True)
    t = time.perf_counter()
    build.build_all()
    print(f"built {', '.join(build.SOURCES)} for sm_90a in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    # phase DR's DR4 and DR4v touch no device: they run on the CPU beside
    # every phase until path_dr reads them
    dr4_jobs = dr4_start()
    try:
        return _main(args, torch, card, dr4_jobs)
    finally:
        dr_stop(dr4_jobs)


def _main(args, torch, card, dr4_jobs) -> int:
    """Every phase after the build, DR4 and DR4v already running."""
    from repro_torch.configs import get_config
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.kernels import build, ops, tolerance as tol
    from repro_torch.kernels import fused as kern_fused

    for name, report in build.PTXAS_REPORT.items():
        regs = [ln.strip() for ln in report.splitlines()
                if "registers" in ln or "Compiling entry" in ln]
        print(f"ptxas {name}: " + " | ".join(regs), flush=True)

    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=args.layers)
    grid = check_fused_grid(torch, ops, tol)
    print(f"fused_mvm CPU test grid on the card: {len(tol.FUSED_GRID)} "
          f"cases within the bound, {grid['flips']} one-code flips, max ulp "
          f"{grid['max_ulp']:.1f}", flush=True)
    fm = fused_full_width(torch, A, E, ops, tol, cfg, args.layers,
                          prefill_m=4 * MAX_LEN)
    cache_dtype = getattr(torch, cfg.dtype)
    fl = flash_checks(torch, ops, tol, cfg, args.layers, MAX_LEN,
                      cache_dtype)
    t = time.perf_counter()
    pgrid = check_parasitic_grids(torch, ops, tol)
    print(f"parasitic/legacy CPU test grids on the card: "
          f"{len(tol.FUSED_PARASITIC_GRID)} fused parasitic, "
          f"{len(tol.BITLINE_GRID)} bit-line, "
          f"{len(tol.LEGACY_PARASITIC_GRID)} legacy parasitic, "
          f"{len(tol.LEGACY_GRID)} legacy cases within the bound; max_abs_err "
          f"{pgrid} ({time.perf_counter() - t:.1f} s)", flush=True)
    t = time.perf_counter()
    par = parasitic_full_width(torch, A, E, ops, tol, cfg, args.layers,
                               prefill_m=4 * MAX_LEN)
    print(f"parasitic/legacy full-width checks in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    pa = paged_checks(torch, ops, tol, cfg, args.layers)
    edge = check_attn_edge_grid(torch, ops, tol)
    print(f"attention edge grid on the card: {len(tol.ATTN_EDGE_GRID)} "
          f"cases, both kernels within the bound, paged equal to flash_decode "
          f"on the gathered view; max_abs_err {edge:.3e}", flush=True)
    bs_grid = check_bitserial_grid(torch, ops, tol)
    print(f"analog_mvm_bitserial CPU test grid on the card: "
          f"{len(tol.BITSERIAL_GRID)} cases within the bound, max_abs_err "
          f"{bs_grid:.3e}; paged and bit-serial checks in "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    cfg, step_s, counts, params, pack, reqs, calib = main_path(
        torch, args, kern_fused)
    print(f"decode step (4 rows, {cfg.n_layers} layers, flash attention): "
          f"{step_s * 1e3:.3f} ms, {4 / step_s:.1f} tokens/s on {card}",
          flush=True)
    t = time.perf_counter()
    p1_counts, p1 = path_p1(torch, cfg, params, pack, reqs, calib, kern_fused)
    print(f"path P1 in {time.perf_counter() - t:.1f} s", flush=True)
    short = [(p[:8], m) for p, m in reqs[:3]]
    t = time.perf_counter()
    p2_counts, bl = path_p2(torch, ops, tol, cfg, params, pack, short, calib,
                            kern_fused, R_HAT, reqs)
    p2_ideal, _ = path_p2(torch, ops, tol, cfg, params, pack, short, calib,
                          kern_fused, 0.0, reqs)
    print(f"path P2 in {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    pg_counts, pg_stats, pg_step = path_pg(torch, cfg, params, pack, reqs,
                                           kern_fused)
    print(f"path PG decode step (4 rows, {cfg.n_layers} layers, paged "
          f"attention kernel): {pg_step * 1e3:.3f} ms, {4 / pg_step:.1f} "
          f"tokens/s on {card}; path PG in {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    bs = bitserial_full_width(torch, ops, tol, cfg, pack, kern_fused)
    print(f"Design D at four full-width sites in {time.perf_counter() - t:.1f}"
          f" s", flush=True)
    an = phase_an(torch, cfg, params, pack, kern_fused)
    del pack
    torch.cuda.empty_cache()
    pd_counts, pd = path_pd(torch, cfg, params, reqs, calib, kern_fused)
    print(f"path PD decode step (4 rows, {cfg.n_layers} layers, flash "
          f"attention, healed pack): {pd['step_s'] * 1e3:.3f} ms, "
          f"{4 / pd['step_s']:.1f} tokens/s on {card}; launches "
          f"fused_mvm={pd_counts['fused_mvm']} flash_decode="
          f"{pd_counts['flash_decode']} paged_attention="
          f"{pd_counts['paged_attention']}", flush=True)

    t = time.perf_counter()
    sw_counts, sw = path_sw(torch, ops, cfg, params, calib, kern_fused)
    print(f"path SW in {time.perf_counter() - t:.1f} s; launches "
          f"{sw_counts}", flush=True)
    del params
    torch.cuda.empty_cache()

    rw_launches, rw = path_rw(torch, ops, tol, args, kern_fused)
    print(f"path RW decode step: {rw['step_s'] * 1e3:.3f} ms, "
          f"{4 / rw['step_s']:.1f} tokens/s on {card}; B1 launches "
          f"{rw_launches}", flush=True)
    fam_launches = phase_fam(torch, kern_fused)
    dr_jobs = dr_start(args.layers, dr4_jobs)
    try:
        tr, so, dr = (path_tr(torch, args, kern_fused),
                      path_so(torch, args, kern_fused),
                      path_dr(torch, args, kern_fused, dr_jobs))
    finally:
        dr_stop(dr_jobs)
    print(f"path TR step: {tr['step_s']:.3f} s, {tr['tokens_s']:.0f} "
          f"tokens/s, AdamW update {tr['update_s'] * 1e3:.1f} ms, peak "
          f"{tr['peak']:.2f} GiB, checkpoint {tr['ck_gb']:.3f} GB saved in "
          f"{tr['save_s']:.2f} s and restored in {tr['restore_s']:.2f} s, "
          f"stragglers flagged {tr['stragglers']} on {card}", flush=True)
    print(f"path SO step: sharded {so['step_s']:.3f} s, unsharded "
          f"{so['ref_step_s']:.3f} s, peak {so['peak']:.2f} GiB on {card}",
          flush=True)
    print(f"phase DR: TR's reduced step {dr['step_s']:.4f} s against its "
          f"H100 roofline bound {dr['bound_s']:.4f} s on {card}", flush=True)
    torch.cuda.empty_cache()
    ex = phase_ex(torch, kern_fused)
    ex_launches = {name: sum(n[name] for n in ex["launches"].values())
                   for name in kern_fused.LAUNCHES}
    print(f"phase EX: train_lm median step {ex['step_s'] * 1e3:.2f} ms, "
          f"peak {ex['peak']:.2f} GiB ({ex['peak'] - ex['held']:.2f} GiB "
          f"above what earlier phases held) on {card}; launches over the six "
          f"examples {ex_launches}", flush=True)

    kernels = [
        {"name": "fused_mvm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_mvm.cu",
         "replaces": FUSED_REPLACES,
         "launches": counts["fused_mvm"] + sw_counts["fused_mvm"]
         + rw_launches + fam_launches + an["fused_mvm"],
         "max_abs_err": max(fm["max_abs_err"], grid["max_abs_err"],
                            rw["max_abs_err"]),
         "ms": fm["ms"], "plain_ms": fm["plain_ms"],
         "bound_ms": fm["bound_ms"], "bound_by": fm["bound_by"],
         "library_ms": fm["library_ms"]},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": FLASH_REPLACES,
         "launches": counts["flash_decode"] + an["flash_decode"],
         "max_abs_err": max(fl["max_abs_err"], edge), "ms": fl["ms"],
         "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
         "bound_by": fl["bound_by"], "library_ms": fl["library_ms"],
         "shapes": fl["shapes"]},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": PAGED_REPLACES,
         "launches": pg_counts["paged_attention"] + an["paged_attention"],
         "max_abs_err": max(pa["max_abs_err"], edge), "ms": pa["ms"],
         "plain_ms": pa["plain_ms"], "bound_ms": pa["bound_ms"],
         "bound_by": pa["bound_by"], "library_ms": pa["library_ms"],
         "shapes": pa["shapes"]},
    ]
    par["bitline_mvm"] = bl
    for name, src, replaces, launches in (
            ("fused_mvm_parasitic", "fused_mvm_parasitic.cu",
             PARASITIC_REPLACES, p1_counts["fused_mvm_parasitic"]),
            ("bitline_mvm", "bitline.cu", BITLINE_REPLACES,
             p2_counts["bitline_mvm"] + sw_counts["bitline_mvm"]),
            ("analog_bitline_diff", "fused_mvm_parasitic.cu",
             BL_DIFF_REPLACES, p2_counts["analog_bitline_diff"]
             + sw_counts["analog_bitline_diff"]),
            ("analog_mvm_diff", "fused_mvm.cu", MVM_DIFF_REPLACES,
             p2_ideal["analog_mvm_diff"])):
        t = par[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(t["max_abs_err"], pgrid[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    kernels.append({
        "name": "analog_mvm_bitserial", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mvm.cu",
        "replaces": BITSERIAL_REPLACES, "launches": bs["launches"],
        "max_abs_err": max(bs["max_abs_err"], bs_grid), "ms": bs["ms"],
        "plain_ms": bs["plain_ms"], "bound_ms": bs["bound_ms"],
        "bound_by": bs["bound_by"], "library_ms": bs["library_ms"]})
    for k in kernels:
        k["launches"] += ex_launches[k["name"]]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
