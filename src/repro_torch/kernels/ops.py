"""Public wrappers for the serving kernels (counterpart of
``repro.kernels.ops``).

``backend="kernel"`` launches the hand-written CUDA kernel for a CUDA
tensor and raises if it cannot; for a CPU tensor it runs the plain
PyTorch version, which is the only reason that version runs.
``backend="oracle"`` asks for the plain version on any device (the
``AnalogSpec.fused="oracle"`` and ``attn_backend="flash_oracle"``
settings; ``chip_smoke.py`` uses it to hold each kernel against its plain
version on the card).  The reference's Mosaic tiling (``_pick_tile``'s
128-lane rule and the lane padding) has no counterpart: the CUDA kernels
take any M, N and head dimension, and mask their own ragged edges.

Two records serve ``repro_torch.analysis``'s contracts.
:data:`ROUTE_CALLS` counts each op's calls on each route, so a CPU run can
count what would launch on a card (``kernels.fused.LAUNCHES`` stays 0
there: the plain versions run).  :data:`BUILD_SIGNATURES` holds one
static identity per fused MVM call on the kernel route, CPU or card, in
``core.analog.fuse_signature``'s format, as the reference's
``kernels.fused.BUILD_SIGNATURES`` does for its traced kernels.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.parasitics import parasitics_off
from repro_torch.kernels import analog_mvm as _k_mvm
from repro_torch.kernels import bitline as _k_bl
from repro_torch.kernels import fused as _k_fused
from repro_torch.kernels import paged as _k_paged
from repro_torch.kernels import ref as _k_ref

BACKENDS = ("kernel", "oracle")

#: calls of each kernel's op by route in this process:
#: ``(kernel, route)`` -> calls, the kernel named as in
#: ``kernels.fused.LAUNCHES``; route ``"kernel"`` (launched), ``"cpu"``
#: (the plain version standing in for the kernel on a CPU tensor) or
#: ``"oracle"`` (the plain version asked for)
ROUTE_CALLS: Dict[Tuple[str, str], int] = collections.Counter()

#: static identities of the fused MVM calls on the kernel route:
#: ``("linear", S, cell_bits, adc_bits, n_bits, None)`` and
#: ``("parasitic", S, cell_bits, adc_bits, None, n_bits)``
BUILD_SIGNATURES: set = set()


def _check_backend(backend: str, what: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown {what} backend {backend!r}")


def _plain(backend: str, t: torch.Tensor, kernel: str) -> bool:
    """Run the plain version: asked for, or a CPU tensor.  Counts the call
    in :data:`ROUTE_CALLS`."""
    route = ("oracle" if backend == "oracle"
             else "cpu" if t.device.type == "cpu" else "kernel")
    ROUTE_CALLS[(kernel, route)] += 1
    return route != "kernel"


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def fused_mvm(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued signed
    g_pos: torch.Tensor,     # (S, P, rows, N)
    g_neg: torch.Tensor,     # (S, P, rows, N)
    *,
    adc_lo: torch.Tensor,    # (S,) per-slice calibrated range
    adc_hi: torch.Tensor,
    adc_bits: int,
    cell_bits: int,
    n_bits: Optional[int],   # None = analog input accumulation
    scale,                   # scalar: gain * w_scale * x_scale
    backend: str = "kernel",
) -> torch.Tensor:
    """Fused analog MVM chain (dot + ADC + dequant + slice/bit
    shift-and-add in one launch); returns the dequantized (M, N)."""
    _check_backend(backend, "fused_mvm")
    if backend == "kernel":
        BUILD_SIGNATURES.add(("linear", g_pos.shape[0], cell_bits,
                              adc_bits, n_bits, None))
    if _plain(backend, x_parts, "fused_mvm"):
        return _k_ref.fused_mvm_diff(
            x_parts, g_pos, g_neg, adc_lo, adc_hi, scale,
            adc_bits=adc_bits, cell_bits=cell_bits, n_bits=n_bits)
    return _k_fused.fused_mvm_cuda(
        _f32(x_parts), g_pos, g_neg, adc_lo, adc_hi, scale,
        adc_bits=adc_bits, cell_bits=cell_bits, n_bits=n_bits)


def _unsliced(g_pos: torch.Tensor, g_neg: torch.Tensor):
    """(S=1, P, rows, N) stacks as (P, rows, N); (P, rows, N) as they are."""
    if g_pos.ndim == 4:
        if g_pos.shape[0] != 1:
            raise ValueError(f"the legacy kernels take unsliced stacks, got "
                             f"{g_pos.shape[0]} slices")
        return g_pos[0], g_neg[0]
    return g_pos, g_neg


def fused_mvm_parasitic(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued signed
    g_pos: torch.Tensor,     # (S, P, rows, N)
    g_neg: torch.Tensor,     # (S, P, rows, N)
    *,
    r_hat,                   # scalar parasitic level
    adc_lo: torch.Tensor,    # (S,)
    adc_hi: torch.Tensor,
    adc_bits: int,
    cell_bits: int,
    n_bits: int,
    scale,                   # scalar: gain * w_scale * x_scale
    backend: str = "kernel",
) -> torch.Tensor:
    """Fused parasitic analog MVM chain (per-bit Thomas solve of both lines,
    analog bit fold, ADC, dequant and slice shift-and-add in one launch);
    returns the dequantized (M, N)."""
    _check_backend(backend, "fused_mvm_parasitic")
    if backend == "kernel":
        BUILD_SIGNATURES.add(("parasitic", g_pos.shape[0], cell_bits,
                              adc_bits, None, n_bits))
    if _plain(backend, x_parts, "fused_mvm_parasitic"):
        return _k_ref.fused_mvm_parasitic(
            x_parts, g_pos, g_neg, r_hat, adc_lo, adc_hi, scale,
            adc_bits=adc_bits, cell_bits=cell_bits, n_bits=n_bits)
    return _k_fused.fused_mvm_parasitic_cuda(
        _f32(x_parts), g_pos, g_neg, r_hat, adc_lo, adc_hi, scale,
        adc_bits=adc_bits, cell_bits=cell_bits, n_bits=n_bits)


def bitline_mvm(
    g: torch.Tensor,         # (K, N), or (G, K, N) arrays
    x: torch.Tensor,         # (M, K), or (X, M, K) signed planes, G % X == 0
    r_hat,                   # scalar parasitic level
    *,
    backend: str = "kernel",
) -> torch.Tensor:
    """Parasitic bit-line MVM: output currents (M, N), or (G, M, N) with
    array ``i`` driven by plane batch ``i % X`` — one launch for every
    (slice, partition) array.  A zero ``r_hat`` on one (K, N) array is the
    ideal ``x @ g``, a plain product outside any kernel (as in the
    reference); the batched form takes only a parasitic ``r_hat``."""
    _check_backend(backend, "bitline_mvm")
    if parasitics_off(r_hat):
        if g.ndim != 2:
            raise ValueError("a zero r_hat takes one (K, N) array: the "
                             "batched form is for parasitic solves")
        return x @ g
    if _plain(backend, g, "bitline_mvm"):
        return _k_ref.bitline_mvm(g, x, r_hat)
    if g.ndim == 2:
        return _k_bl.bitline_mvm_cuda(_f32(g)[None], _f32(x)[None], r_hat)[0]
    return _k_bl.bitline_mvm_cuda(_f32(g), _f32(x), r_hat)


def analog_mvm_parasitic(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued signed
    g_pos: torch.Tensor,     # (S=1, P, rows, N) or (P, rows, N)
    g_neg: torch.Tensor,
    *,
    r_hat,                   # scalar parasitic level
    n_bits: int,
    adc_lo: torch.Tensor,
    adc_hi: torch.Tensor,
    adc_bits: int,
    gain: float,
    backend: str = "kernel",
) -> torch.Tensor:
    """Legacy Design-A analog MVM under parasitic bit-line resistance (per
    input bit both lines solved, analog bit fold, one ADC per partition,
    partition sum in one launch); returns (M, N) code units."""
    _check_backend(backend, "analog_mvm_parasitic")
    g_pos, g_neg = _unsliced(g_pos, g_neg)
    if _plain(backend, x_parts, "analog_bitline_diff"):
        return _k_ref.analog_mvm_parasitic_diff(
            x_parts, g_pos, g_neg, r_hat=r_hat, n_bits=n_bits, adc_lo=adc_lo,
            adc_hi=adc_hi, adc_bits=adc_bits, gain=gain)
    return _k_bl.analog_bitline_diff_cuda(
        _f32(x_parts), _f32(g_pos), _f32(g_neg), r_hat, adc_lo, adc_hi,
        n_bits=n_bits, adc_bits=adc_bits, gain=gain)


def analog_mvm(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued
    g_pos: torch.Tensor,     # (S=1, P, rows, N) or (P, rows, N)
    g_neg: torch.Tensor,
    *,
    adc_lo: torch.Tensor,
    adc_hi: torch.Tensor,
    adc_bits: int,
    gain: float,
    backend: str = "kernel",
) -> torch.Tensor:
    """Legacy Design-A analog MVM (dot, ADC, partition sum in one launch);
    returns (M, N) code units."""
    _check_backend(backend, "analog_mvm")
    g_pos, g_neg = _unsliced(g_pos, g_neg)
    if _plain(backend, x_parts, "analog_mvm_diff"):
        return _k_ref.analog_mvm_diff(
            x_parts, g_pos, g_neg, adc_lo=adc_lo, adc_hi=adc_hi,
            adc_bits=adc_bits, gain=gain)
    return _k_mvm.analog_mvm_diff_cuda(
        _f32(x_parts), _f32(g_pos), _f32(g_neg), adc_lo, adc_hi,
        adc_bits=adc_bits, gain=gain)


def analog_mvm_bitserial(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued signed
    g_pos: torch.Tensor,     # (S=1, P, rows, N) or (P, rows, N)
    g_neg: torch.Tensor,
    *,
    n_bits: int,
    adc_lo: torch.Tensor,
    adc_hi: torch.Tensor,
    adc_bits: int,
    gain: float,
    backend: str = "kernel",
) -> torch.Tensor:
    """Design-D bit-serial analog MVM (signed bit planes, a dot and an ADC
    per bit, shift-and-add, partition sum in one launch); returns (M, N)
    code units."""
    _check_backend(backend, "analog_mvm_bitserial")
    g_pos, g_neg = _unsliced(g_pos, g_neg)
    if _plain(backend, x_parts, "analog_mvm_bitserial"):
        return _k_ref.analog_mvm_bitserial(
            x_parts, g_pos, g_neg, n_bits=n_bits, adc_lo=adc_lo,
            adc_hi=adc_hi, adc_bits=adc_bits, gain=gain)
    return _k_mvm.analog_mvm_bitserial_cuda(
        _f32(x_parts), _f32(g_pos), _f32(g_neg), adc_lo, adc_hi,
        n_bits=n_bits, adc_bits=adc_bits, gain=gain)


def paged_attention(
    q: torch.Tensor,          # (B, H, hd)
    k_pages: torch.Tensor,    # (P, page_size, KV, hd) pool
    v_pages: torch.Tensor,    # (P, page_size, KV, hd)
    ptab: torch.Tensor,       # (B, NP) block table
    kv_len: torch.Tensor,     # (B,) valid positions per row
    *,
    backend: str = "kernel",
) -> torch.Tensor:
    """Decode attention over a paged KV pool, scaled by ``hd ** -0.5``; the
    kernel reads each row's pages through the block table (no gathered
    copy, the pool in its own dtype).  Returns (B, H, hd) in ``q``'s dtype.
    Positions at or beyond ``kv_len[b]`` contribute exact zeros, so the
    table's tail past a row's fill is never read; a row with ``kv_len[b]``
    0 has only masked logits and averages v over all ``NP * page_size``
    positions, as the reference does."""
    _check_backend(backend, "paged_attention")
    if _plain(backend, q, "paged_attention"):
        out = _k_ref.paged_attention_decode(q, k_pages, v_pages, ptab, kv_len)
    else:
        out = _k_paged.paged_attention_cuda(q, k_pages, v_pages, ptab, kv_len)
    return out.to(q.dtype)


def flash_attention_decode(
    q: torch.Tensor,          # (B, H, hd)
    k: torch.Tensor,          # (B, S, KV, hd) dense per-slot cache
    v: torch.Tensor,          # (B, S, KV, hd)
    kv_len: torch.Tensor,     # (B,) valid positions per row
    *,
    backend: str = "kernel",
) -> torch.Tensor:
    """Flash-decode attention over the dense per-slot KV cache, scaled by
    ``hd ** -0.5``; returns (B, H, hd) in ``q``'s dtype.  Positions at or
    beyond ``kv_len[b]`` contribute exact zeros; a row with ``kv_len[b]`` 0
    has only masked logits and averages v over the cache zero-padded to
    the reference's 8-position blocks, as the reference does."""
    _check_backend(backend, "flash_attention_decode")
    if _plain(backend, q, "flash_decode"):
        out = _k_ref.flash_attention_decode(q, k, v, kv_len)
    else:
        out = _k_fused.flash_decode_cuda(q, k, v, kv_len)
    return out.to(q.dtype)
