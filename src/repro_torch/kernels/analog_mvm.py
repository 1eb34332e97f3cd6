"""The legacy Design-A and Design-D kernels' launchers and epilogue
(counterpart of ``repro.kernels.analog_mvm``).

:func:`analog_mvm_diff_cuda` launches ``repro_analog_mvm_diff`` of
``csrc/fused_mvm.cu`` (the fused kernel with the legacy epilogue), replacing
``repro.kernels.analog_mvm.analog_mvm_diff_pallas``: per K-partition one
dot of the activations with ``g_pos - g_neg`` (float32, rows in ascending
order), one value-unit ADC, ``* gain``, and the sum over partitions,
returning code units.  It checks its operands, allocates the output,
launches on PyTorch's current stream, raises if the launch was refused, and
adds one to its count in ``kernels.fused.LAUNCHES``.  The plain version is
``kernels.ref.analog_mvm_diff``.

:func:`analog_mvm_bitserial_cuda` launches ``repro_analog_mvm_bitserial``
of the same source (bit-serial accumulation with the legacy epilogue),
replacing ``repro.kernels.analog_mvm.analog_mvm_bitserial_pallas``: per
K-partition and signed input bit plane one dot and one value-unit ADC, the
``2**b`` shift-add, ``* gain``, the sum over partitions; its plain version
is ``kernels.ref.analog_mvm_bitserial``.

:func:`_adc_epilogue` is the legacy epilogue the plain versions share.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import true_div
from repro_torch.kernels.fused import (LAUNCHES, MAX_BITS, _check_launch,
                                       _lib, _mvm_shapes, _ptr, _scalar,
                                       _stream)

_DIFF_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                             ctypes.c_void_p])
_BITSERIAL_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])


def _adc_epilogue(v, lo, hi, bits: int):
    """The legacy kernels' ADC: clip/round to ``2**bits`` levels and return
    the value ``lo + code * lsb``, ``lsb = (hi - lo) / (2**bits - 1)``, with
    no degenerate-range guard (as in the reference)."""
    n_levels = 2 ** bits
    lsb = true_div(hi - lo, n_levels - 1)
    code = torch.clamp(torch.round((v - lo) / lsb), 0.0, n_levels - 1.0)
    return lo + code * lsb


def analog_mvm_diff_cuda(
    x_parts: torch.Tensor,   # (M, P, rows) float32, integer-valued
    g_pos: torch.Tensor,     # (P, rows, N) float32
    g_neg: torch.Tensor,     # (P, rows, N) float32
    adc_lo: torch.Tensor,    # scalar / (1,) calibrated range
    adc_hi: torch.Tensor,
    *,
    adc_bits: int,
    gain: float,
) -> torch.Tensor:
    """Launch the legacy Design-A kernel; returns (M, N) code units."""
    dev, m, p, rows, n = _mvm_shapes(x_parts, g_pos, g_neg, sliced=False)
    if not 1 <= adc_bits <= 24:
        raise ValueError(f"adc_bits={adc_bits} out of the kernel's range")
    lo, hi = _scalar(adc_lo, dev), _scalar(adc_hi, dev)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return y
    lib = _lib("fused_mvm", ("repro_analog_mvm_diff",), _DIFF_ARGS)
    with torch.cuda.device(dev):
        rc = lib.repro_analog_mvm_diff(
            _ptr(x_parts), _ptr(g_pos), _ptr(g_neg), _ptr(lo), _ptr(hi),
            _ptr(y), m, p, rows, n, int(adc_bits), float(gain), _stream(dev))
    _check_launch(rc, "analog_mvm_diff")
    LAUNCHES["analog_mvm_diff"] += 1
    return y


def analog_mvm_bitserial_cuda(
    x_parts: torch.Tensor,   # (M, P, rows) float32, integer-valued signed
    g_pos: torch.Tensor,     # (P, rows, N) float32
    g_neg: torch.Tensor,     # (P, rows, N) float32
    adc_lo: torch.Tensor,    # scalar / (1,) calibrated range
    adc_hi: torch.Tensor,
    *,
    n_bits: int,
    adc_bits: int,
    gain: float,
) -> torch.Tensor:
    """Launch the Design-D bit-serial kernel; returns (M, N) code units."""
    dev, m, p, rows, n = _mvm_shapes(x_parts, g_pos, g_neg, sliced=False)
    if not 1 <= n_bits <= MAX_BITS:
        raise ValueError(f"analog_mvm_bitserial takes n_bits in "
                         f"1..{MAX_BITS}, got {n_bits}")
    if not 1 <= adc_bits <= 24:
        raise ValueError(f"adc_bits={adc_bits} out of the kernel's range")
    lo, hi = _scalar(adc_lo, dev), _scalar(adc_hi, dev)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return y
    lib = _lib("fused_mvm", ("repro_analog_mvm_bitserial",), _BITSERIAL_ARGS)
    with torch.cuda.device(dev):
        rc = lib.repro_analog_mvm_bitserial(
            _ptr(x_parts), _ptr(g_pos), _ptr(g_neg), _ptr(lo), _ptr(hi),
            _ptr(y), m, p, rows, n, int(n_bits), int(adc_bits), float(gain),
            _stream(dev))
    _check_launch(rc, "analog_mvm_bitserial")
    LAUNCHES["analog_mvm_bitserial"] += 1
    return y
