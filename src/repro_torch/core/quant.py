"""Integer quantization on both sides of the analog MVM (counterpart of
``repro.core.quant``).

Weights are quantized to 8 bits before mapping (paper Sec. 4.3) and
activations to 8 bits with a calibrated L1-optimal clipping range; the
bit-plane decomposition feeds input bit slicing (Sec. 2.2).  Conventions
are the reference's: symmetric signed ranges so zero is exact, and signed
inputs modelled as opposite-polarity voltages (planes in {-1, 0, +1}).

``torch.round`` rounds half to even, like ``jnp.round``; every integer
stage here matches the reference exactly (``tests/test_torch_core.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` for a Python number ``d``, as an IEEE division on every
    device.  PyTorch's CUDA kernels turn division by a Python scalar into
    multiplication by its rounded reciprocal, which can land an ulp away
    from the reference's division; dividing by a tensor does not."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def div_as_compiled(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` for a Python number ``d`` as XLA compiles a division by a
    constant: a multiply by the float32 reciprocal of ``d``, rounded once on
    the host.  This is what the reference's jitted ``x / d`` computes, on
    every device; an IEEE division (:func:`true_div`, or the CPU's ``x /
    d``) can land an ulp away from it."""
    return x * float(np.float32(1.0) / np.float32(d))


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Integer-valued float tensor plus its dequantization scale."""

    values: torch.Tensor       # integer-valued float tensor
    scale: torch.Tensor        # scalar (0-d) or broadcastable scale
    bits: int
    signed: bool

    def dequant(self) -> torch.Tensor:
        return self.values * self.scale


def quantize_weights(
    w: torch.Tensor,
    bits: int = 8,
    *,
    magnitude_bits: Optional[int] = None,
    per_channel: bool = False,
    eps: float = 1e-12,
) -> QuantizedTensor:
    """Symmetric signed quantization of a weight matrix.

    ``magnitude_bits`` overrides the integer range (sliced differential
    uses 8 magnitude bits, unsliced 7); ``None`` means ``bits - 1``.
    """
    m = (bits - 1) if magnitude_bits is None else magnitude_bits
    qmax = 2 ** m - 1
    if per_channel:
        absmax = w.abs().amax(dim=0, keepdim=True)
    else:
        absmax = w.abs().amax()
    scale = true_div(torch.clamp(absmax, min=eps), qmax)
    w_int = torch.clamp(torch.round(w / scale), -qmax, qmax)
    return QuantizedTensor(values=w_int, scale=scale, bits=m + 1, signed=True)


def quantize_acts(
    x: torch.Tensor,
    bits: int = 8,
    *,
    signed: bool = True,
    clip_lo: Optional[torch.Tensor] = None,
    clip_hi: Optional[torch.Tensor] = None,
    eps: float = 1e-12,
) -> QuantizedTensor:
    """Quantize activations to ``bits`` with an optional calibrated range.

    Signed activations are symmetric around zero (so the sign/magnitude
    bit planes are exact); unsigned ones use ``[0, clip_hi]``.
    """
    if signed:
        if clip_hi is None:
            absmax = x.abs().amax()
        else:
            hi = torch.as_tensor(clip_hi, device=x.device)
            lo = -hi if clip_lo is None else torch.as_tensor(
                clip_lo, device=x.device)
            absmax = torch.maximum(lo.abs(), hi.abs())
        qmax = 2 ** (bits - 1) - 1
        scale = true_div(torch.clamp(absmax, min=eps), qmax)
        x_int = torch.clamp(torch.round(x / scale), -qmax, qmax)
        return QuantizedTensor(values=x_int, scale=scale, bits=bits,
                               signed=True)
    hi = x.amax() if clip_hi is None else torch.as_tensor(
        clip_hi, device=x.device)
    qmax = 2 ** bits - 1
    scale = true_div(torch.clamp(hi, min=eps), qmax)
    x_int = torch.clamp(torch.round(x / scale), 0, qmax)
    return QuantizedTensor(values=x_int, scale=scale, bits=bits, signed=False)


#: ``exp(linspace(log 2**-6, 0, 32))`` as the reference evaluates it in
#: float32 (op by op), bit for bit: the L1-optimal clip is one of these
#: fractions of absmax, so an ulp here is an ulp in the calibrated range
#: and in every activation scale derived from it
_CLIP_FRACTION_BITS = (
    0x3c800000, 0x3c926096, 0x3ca764a6, 0x3cbf6d24, 0x3cdae8f2, 0x3cfa56e3,
    0x3d0f2405, 0x3d23b11d, 0x3d3b318d, 0x3d5611c8, 0x3d74cdd8, 0x3d8bf9c6,
    0x3da01288, 0x3db70def, 0x3dd1560c, 0x3def6423, 0x3e08e16e, 0x3e1c886e,
    0x3e3301bf, 0x3e4cb518, 0x3e6a190a, 0x3e85da9c, 0x3e991260, 0x3eaf0c7c,
    0x3ec82e56, 0x3ee4ebeb, 0x3f02e4ee, 0x3f15afe7, 0x3f2b2d9a, 0x3f43c133,
    0x3f5fdc1a, 0x3f800000,
)


def _clip_fractions(device) -> torch.Tensor:
    bits = torch.tensor(_CLIP_FRACTION_BITS, dtype=torch.int64)
    return bits.to(torch.int32).view(torch.float32).to(device)


def calibrate_act_range(
    samples: torch.Tensor,
    bits: int = 8,
    *,
    signed: bool = True,
    search_bits: int = 12,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clipping range minimizing the L1 quantization error (Sec. 4.3).

    Sweeps 32 candidate clips between ``absmax / 2**6`` and ``absmax``,
    each snapped to a ``2**search_bits`` grid, and keeps the L1-optimal
    one; returns ``(lo, hi)``, symmetric for signed data.  The reference
    vmaps the candidates; here they run one after another, which keeps
    memory at one copy of the samples.
    """
    flat = samples.reshape(-1).float()
    absmax = torch.clamp(flat.abs().amax(), min=1e-12)
    cands = absmax * _clip_fractions(flat.device)
    grid = 2.0 ** search_bits
    steps = torch.round(cands / absmax * grid)
    # grid is 2**search_bits, so its reciprocal is exact on every device
    snapped = steps / grid * absmax  # repro: ignore[scalar-div] a 2**k
    errs = []
    for hi in snapped:
        q = quantize_acts(flat, bits, signed=signed, clip_hi=hi)
        errs.append((q.dequant() - flat).abs().sum())
    best = cands[torch.argmin(torch.stack(errs))]
    if signed:
        return -best, best
    return torch.zeros_like(best), best


def bit_planes(x_int: torch.Tensor, n_planes: int, *,
               signed: bool = True) -> torch.Tensor:
    """Decompose integer-valued ``x_int`` into ``(n_planes,) + shape``
    bit planes with ``sum_b 2**b * planes[b] == x_int`` exactly; signed
    planes carry ``sign(x)`` (values in {-1, 0, +1})."""
    if signed:
        sign = torch.sign(x_int)
        mag = x_int.abs()
    else:
        sign = torch.ones_like(x_int)
        mag = x_int
    mag = mag.to(torch.int32)
    planes = [((mag >> b) & 1).to(x_int.dtype) * sign
              for b in range(n_planes)]
    return torch.stack(planes, dim=0)


def n_input_planes(input_bits: int, signed: bool) -> int:
    """Number of magnitude bit planes for an ``input_bits`` quantizer."""
    return input_bits - 1 if signed else input_bits
