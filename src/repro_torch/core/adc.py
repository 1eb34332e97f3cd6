"""ADC models (paper Sec. 2.4, 6): Full Precision Guarantee vs calibrated
compressing ADCs; counterpart of ``repro.core.adc``.

An array's analog output is a normalized value ``V``; the ADC clips it to
``[lo, hi]`` and quantizes to ``2**bits`` uniform levels, handing on the
dequantized level.  ``fpg`` sizes the resolution by Eq. (4)/(5); the
calibrated style takes ``[lo, hi]`` from the inner 99.98% of observed
values (Sec. 6.2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.quant import true_div

#: fraction of probability mass kept inside the calibrated ADC range
CALIB_COVERAGE = 0.9998


def fpg_bits(weight_bits_per_cell: int, input_bits: int, n_rows: int) -> int:
    """Eq. (4)/(5): ADC bits needed for a unique level per possible output."""
    b_w, b_in = weight_bits_per_cell, input_bits
    b_out = b_w + b_in + math.log2(n_rows)
    if not (b_w > 1 and b_in > 1):
        b_out -= 1
    return math.ceil(b_out)


@dataclasses.dataclass(frozen=True)
class ADCConfig:
    """Static ADC description; ``style`` is ``"none"`` (ideal), ``"fpg"``
    or ``"calibrated"`` (fixed ``bits``, range from calibration)."""

    style: str = "calibrated"
    bits: int = 8

    def __post_init__(self):
        if self.style not in ("none", "fpg", "calibrated"):
            raise ValueError(
                f"ADCConfig.style must be one of ('none', 'fpg', "
                f"'calibrated'), got {self.style!r}")
        if self.bits < 1:
            raise ValueError(f"ADCConfig.bits must be >= 1, got {self.bits}")


def adc_quantize(v: torch.Tensor, lo, hi, bits: int) -> torch.Tensor:
    """Clip to ``[lo, hi]`` and quantize to ``2**bits`` uniform levels;
    returns the dequantized level (deterministic, Sec. 6.3)."""
    n_levels = 2 ** bits
    if torch.is_tensor(hi - lo):
        lsb = true_div(hi - lo, n_levels - 1)
        lsb = torch.where(lsb <= 0, torch.ones_like(lsb), lsb)
    else:                                # the FPG path's Python floats
        lsb = (hi - lo) / (n_levels - 1)
        lsb = 1.0 if lsb <= 0 else lsb   # degenerate range guard
    code = torch.clamp(torch.round((v - lo) / lsb), 0, n_levels - 1)
    return lo + code * lsb


def fpg_range(n_rows: int, max_code_g: float, *, signed_inputs: bool,
              differential: bool) -> Tuple[float, float]:
    """Full analytic output range of one array in normalized units."""
    top = n_rows * max_code_g
    if signed_inputs or differential:
        return (-top, top)
    return (0.0, top)


def power_of_two_ranges(needs: torch.Tensor) -> torch.Tensor:
    """Grant per-slice half-ranges ``>= needs`` that are the smallest
    need times powers of two (Sec. 6.2's shift-and-add constraint)."""
    base = needs.amin()
    k = torch.ceil(torch.log2(torch.clamp(needs / base, min=1.0)))
    return base * 2.0 ** k


def percentile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """``q``-th percentile of a 1-D tensor with numpy's ``linear``
    interpolation, by order statistics.

    ``torch.quantile`` refuses inputs above 2**24 elements, and the head's
    pre-ADC calibration tensor at full width holds tens of millions, so
    the two bracketing order statistics come from ``kthvalue`` instead.
    The fractional index is formed in float32 as the reference's compiled
    calibration forms it (``(q * 0.01) * (n - 1)``, XLA having turned the
    division by 100 into a multiplication), and the blend is
    ``low * (1 - t) + high * t``, so calibrated ranges match the
    reference's: in the sparse tails a different rounding of the index
    moves the range by parts in 1e4.
    """
    n = flat.numel()
    pos = (np.float32(q) * np.float32(0.01)) * np.float32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    t = np.float32(pos - low)
    i_lo = int(min(max(low, 0), n - 1))
    i_hi = int(min(max(high, 0), n - 1))
    lo = torch.kthvalue(flat, i_lo + 1).values
    hi = torch.kthvalue(flat, i_hi + 1).values if i_hi != i_lo else lo
    return lo * float(np.float32(1.0) - t) + hi * float(t)


def range_from_samples(v: torch.Tensor, *, coverage: float = CALIB_COVERAGE,
                       symmetric: bool = False):
    """Inner-``coverage`` percentile range of observed pre-ADC values."""
    tail = (1.0 - coverage) / 2.0 * 100.0
    flat = v.reshape(-1)
    lo = percentile(flat, tail)
    hi = percentile(flat, 100.0 - tail)
    if symmetric:
        m = torch.maximum(lo.abs(), hi.abs())
        return -m, m
    return lo, hi
