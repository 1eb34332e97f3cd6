"""The yardstick's arithmetic: the H100's peaks, each kernel's least
time from the operations and bytes its inputs need, and a model's flops.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates): 3.35 TB/s
of HBM and 67 TFLOP/s of float32 outside the tensor cores.  The analog
chain is held to float32 with TF32 off, so float32 is the peak any
implementation of it can reach.  A division counts as 16 float32
operations (a reciprocal on the special-function unit, which issues 16
a clock per SM against 128 float32 lanes)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
DIV_FLOPS = 16


def bound_s(n_bytes: float, n_flops: float) -> float:
    """Least seconds for the work: the larger of its two rooflines."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS)


def sweep_ops(systems: int, rows: int) -> int:
    """float32 operations of ``systems`` Thomas sweeps of ``rows`` rows:
    per row two exact products, three adds, one g * r product and two
    divisions; per system the final division by r."""
    return systems * (rows * (6 + 2 * DIV_FLOPS) + DIV_FLOPS)


def b1_work(m: int, p: int, rows: int, s: int, n: int, planes: int):
    """(bytes, operations) of one fused MVM (kernel B1) call: x (M, P,
    rows) against S slices of (P, rows, N) arrays, ``planes`` input terms
    (1 under analog input accumulation).  The output depends on the
    conductances only through ``g_pos - g_neg``, so one float32 difference
    per weight is counted, read once."""
    n_bytes = 4 * (m * p * rows + s * p * rows * n + m * n)
    return n_bytes, 2 * m * p * rows * n * s * planes


def b5_work(g_arrays: int, k: int, n: int, x_batches: int, m: int):
    """(bytes, operations) of one bit-line MVM (kernel B5) call: G arrays
    (K, N), X plane batches (M, K), array i driven by batch i % X."""
    n_bytes = 4 * (x_batches * m * k + g_arrays * k * n + g_arrays * m * n)
    return n_bytes, sweep_ops(g_arrays * m * n, k)


def b6_work(m: int, p: int, rows: int, n: int, n_bits: int):
    """(bytes, operations) of one legacy parasitic Design-A (kernel B6)
    call: both lines of P (rows, N) arrays swept once per input bit, the
    bit fold and the partition sum."""
    n_bytes = 4 * (m * p * rows + 2 * p * rows * n + m * n)
    systems = 2 * n_bits * m * p * n
    return n_bytes, sweep_ops(systems, rows) + 3 * n_bits * m * p * n


def attention_flops(n_layers: int, heads: int, hd: int, q_len: int,
                    ctx_before: int = 0) -> int:
    """float32-equivalent flops of causal attention for ``q_len`` new
    positions after ``ctx_before`` cached ones: QK and PV, 2 flops a
    multiply-add each, over each position's visible context."""
    visible = q_len * ctx_before + q_len * (q_len + 1) // 2
    return 4 * n_layers * heads * hd * visible
