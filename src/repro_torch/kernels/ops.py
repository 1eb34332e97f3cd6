"""Public wrappers for the serving kernels (counterpart of
``repro.kernels.ops``).

``backend="kernel"`` launches the hand-written CUDA kernel for a CUDA
tensor and raises if it cannot; for a CPU tensor it runs the plain
PyTorch version, which is the only reason that version runs.
``backend="oracle"`` asks for the plain version on any device (the
``AnalogSpec.fused="oracle"`` and ``attn_backend="flash_oracle"``
settings).  The reference's Mosaic tiling (``_pick_tile``'s 128-lane
rule and the lane padding) has no counterpart: the CUDA kernels take any
M, N and head dimension, and mask their own ragged edges.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import fused as _k_fused
from repro_torch.kernels import ref as _k_ref

BACKENDS = ("kernel", "oracle")


def _check_backend(backend: str, what: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown {what} backend {backend!r}")


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
    if backend == "oracle" or x_parts.device.type == "cpu":
        return _k_ref.fused_mvm_diff(
            x_parts, g_pos, g_neg, adc_lo, adc_hi, scale,
            adc_bits=adc_bits, cell_bits=cell_bits, n_bits=n_bits)
    return _k_fused.fused_mvm_cuda(
        x_parts.to(torch.float32).contiguous(), g_pos, g_neg,
        adc_lo, adc_hi, scale,
        adc_bits=adc_bits, cell_bits=cell_bits, n_bits=n_bits)


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
    beyond ``kv_len[b]`` contribute exact zeros."""
    _check_backend(backend, "flash_attention_decode")
    if backend == "oracle" or q.device.type == "cpu":
        out = _k_ref.flash_attention_decode(q, k, v, kv_len)
    else:
        out = _k_fused.flash_decode_cuda(q, k, v, kv_len)
    return out.to(q.dtype)
