"""Range calibration (paper Sec. 4.3, 6.2); counterpart of
``repro.core.calibrate``.

Activation ranges are L1-optimal clips of the float inputs
(``quant.calibrate_act_range``); ADC ranges are the inner-99.98%
percentile ranges of pre-ADC values per (layer, slice), with per-slice
ranges constrained to powers of two of each other for sliced mappings.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core.analog import AnalogSpec, AnalogWeights, analog_matmul


def constrain_power_of_two(lo: torch.Tensor, hi: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round each slice's half-range up to ``base * 2**k`` (Sec. 6.2),
    keeping limits centered.  ``lo``/``hi``: per-slice, shape (S,)."""
    center = (lo + hi) / 2.0
    half = torch.clamp((hi - lo) / 2.0, min=1e-12)
    granted = adc_lib.power_of_two_ranges(half)
    return center - granted, center + granted


def calibrate_adc_for_matmul(x_samples: torch.Tensor, aw: AnalogWeights,
                             spec: AnalogSpec, *,
                             act_hi: Optional[torch.Tensor] = None,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collect pass for one matmul; returns ``(adc_lo, adc_hi)`` (S,).
    Unsliced mappings skip the power-of-two constraint."""
    _, stats = analog_matmul(x_samples, aw, spec, act_hi=act_hi, collect=True)
    lo, hi = stats[:, 0], stats[:, 1]
    if spec.mapping.sliced:
        lo, hi = constrain_power_of_two(lo, hi)
    return lo, hi
