"""Core-level energy & area model (paper Sec. 9.2-9.3, Fig. 21/22, Table 3);
counterpart of ``repro.core.energy``, copied in the same arithmetic order
so every figure equals the reference's, float for float.

A *core* is everything needed for one full-precision MVM: all weight
slices, differential pairs, K-partitions, and input bits, plus the
integrators, switched-capacitor accumulators, ADCs and shift-and-add logic.

The model is a linear composition of per-event component costs.  The
component constants were fit by non-negative least squares (relative-error
weighted) to the five published design points of Table 3 — the fit
reproduces every design within +-20% energy / +-3% area and the headline
ratios (Design E vs A: 111x energy vs paper 107x, 45x area vs paper 46x).
All constants are for the paper's embedded 40nm SONOS process and a
1152x256 8-bit x 8-bit workload normalization (1 MAC = 2 ops).

Event counts per full MVM of a K x N matrix with ``BITS`` input bits:

  ramp events      S * P * (BITS if digital-accum else 1)    per array ramp
  conversions      N * ramp_events                           per column
  integrations     N * S * d * P * BITS                      current conveyor
  sc events        integrations (analog accum only)          switched-cap
  row drives       K * BITS
  shift-adds       conversions
  cell-bit events  K * N * S * d * BITS * activity * g_avg   array power

where S = #weight slices, d = 2 for differential else 1, P = #K-partitions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core.analog import AnalogSpec

# ---- fitted constants (see module docstring) ------------------------------
# energy, picojoules per event
E_RAMP_PJ = 0.0          # ramp generator (absorbed into comparator term)
E_CMP_PJ = 3.857         # per-column 8-bit conversion (comparator + count)
E_INT_PJ = 0.4529        # current-conveyor integration window (10 ns)
E_SC_PJ = 0.0            # switched-cap accumulation (absorbed into E_INT)
E_ROW_PJ = 0.2249        # row driver, per row per input bit
E_SA_PJ = 0.0            # shift-and-add (absorbed into E_CMP)
E_CELL_PJ = 0.013235     # active cell-bit at g = 1 (scales with g_avg)

# area, square microns per instance
A_CELL_UM2 = 0.16166     # 2T SONOS cell, 40 nm embedded process
A_ARRAY_UM2 = 0.0
A_COL_UM2 = 13.927       # column periphery (integrator + comparator)
A_ADC_UM2 = 0.0
A_SA_UM2 = 560.35        # parallel shift-and-add unit
A_ISA_UM2 = 94.01        # input-bit S&A (digital accumulation only)

#: default input-bit activity factor (ReLU-skewed activations, Sec. 8)
DEFAULT_ACTIVITY = 0.3


@dataclasses.dataclass(frozen=True)
class CoreCosts:
    energy_pj: float         # per full MVM
    energy_fj_per_op: float  # 1 MAC = 2 ops
    area_mm2: float
    adc_conversions: int
    n_arrays: int

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _static_counts(spec: AnalogSpec, k: int, n: int):
    m = spec.mapping
    s = m.n_slices
    d = 2 if m.scheme == "differential" else 1
    p = spec.n_partitions(k)
    bits = spec.input_bits
    digital = spec.input_accum == "digital"
    ramp = s * p * (bits if digital else 1)
    conv = n * ramp
    integ = n * s * d * p * bits
    sc = 0 if digital else integ
    row = k * bits
    sa = conv
    return s, d, p, bits, digital, ramp, conv, integ, sc, row, sa


def core_energy(
    spec: AnalogSpec,
    k: int = 1152,
    n: int = 256,
    *,
    g_avg: float,
    activity: float = DEFAULT_ACTIVITY,
) -> float:
    """Energy in pJ for one full-precision MVM.

    ``g_avg`` is the average normalized conductance of the programmed
    arrays (Fig. 6) — the proportional-mapping lever: differential unsliced
    mappings of zero-peaked weight distributions push it to ~0.02 while
    offset mappings sit near 0.5.
    """
    s, d, p, bits, digital, ramp, conv, integ, sc, row, sa = _static_counts(
        spec, k, n
    )
    cell_events = k * n * s * d * bits * activity * g_avg
    return (
        ramp * E_RAMP_PJ
        + conv * E_CMP_PJ
        + integ * E_INT_PJ
        + sc * E_SC_PJ
        + row * E_ROW_PJ
        + sa * E_SA_PJ
        + cell_events * E_CELL_PJ
    )


def core_area(spec: AnalogSpec, k: int = 1152, n: int = 256) -> float:
    """Core area in mm^2."""
    s, d, p, bits, digital, *_ = _static_counts(spec, k, n)
    cells = k * n * s * d
    arrays = s * d * p
    cols = n * s * d * p
    adcs = s * p
    sa_units = n * s * p
    isa_units = n * s * p if digital else 0
    um2 = (
        cells * A_CELL_UM2
        + arrays * A_ARRAY_UM2
        + cols * A_COL_UM2
        + adcs * A_ADC_UM2
        + sa_units * A_SA_UM2
        + isa_units * A_ISA_UM2
    )
    return um2 / 1e6


def core_costs(
    spec: AnalogSpec,
    k: int = 1152,
    n: int = 256,
    *,
    g_avg: float,
    activity: float = DEFAULT_ACTIVITY,
) -> CoreCosts:
    e = core_energy(spec, k, n, g_avg=g_avg, activity=activity)
    ops = 2.0 * k * n
    m = spec.mapping
    d = 2 if m.scheme == "differential" else 1
    return CoreCosts(
        energy_pj=e,
        energy_fj_per_op=e * 1e3 / ops,
        area_mm2=core_area(spec, k, n),
        adc_conversions=spec.adc_conversions_per_mvm(k, n),
        n_arrays=m.n_slices * d * spec.n_partitions(k),
    )


def adc_energy(spec: AnalogSpec, k: int = 1152, n: int = 256, *,
               ramp_scaled: bool = True) -> float:
    """ADC share of one full MVM's energy in pJ, resolution-sensitive.

    The Table-3 component fit prices a conversion at ``E_CMP_PJ``
    regardless of resolution because every fitted design converts at
    8 bits.  A ramp converter counts ``2**bits`` comparator cycles per
    conversion, so ``ramp_scaled=True`` scales the per-conversion energy
    by ``2**(bits - 8)`` — the per-*site* lever heterogeneous profiles
    pull (the reference's ``benchmarks/hetero_precision.py``): dropping
    an MLP class from 8 to 6 bits cuts its conversion energy 4× on the
    widest matrices of the network.  At 8 bits this reproduces the fitted
    model's ADC term exactly.
    """
    s, d, p, bits, digital, ramp, conv, integ, sc, row, sa = _static_counts(
        spec, k, n
    )
    scale = 2.0 ** (spec.adc.bits - 8) if ramp_scaled else 1.0
    return conv * E_CMP_PJ * scale + ramp * E_RAMP_PJ + sa * E_SA_PJ


def energy_breakdown(
    spec: AnalogSpec, k: int = 1152, n: int = 256, *,
    g_avg: float, activity: float = DEFAULT_ACTIVITY,
) -> Dict[str, float]:
    """Per-component energy in pJ (paper Fig. 22(b))."""
    s, d, p, bits, digital, ramp, conv, integ, sc, row, sa = _static_counts(
        spec, k, n
    )
    cell_events = k * n * s * d * bits * activity * g_avg
    return {
        "adc": ramp * E_RAMP_PJ + conv * E_CMP_PJ + sa * E_SA_PJ,
        "integrator": integ * E_INT_PJ + sc * E_SC_PJ,
        "row_drivers": row * E_ROW_PJ,
        "array": cell_events * E_CELL_PJ,
    }
