"""The analog in-situ MVM simulator as a composable PyTorch op (counterpart
of ``repro.core.analog``).

``program`` maps a float weight matrix onto (error-perturbed) conductance
stacks; ``analog_matmul`` executes ``y ~= x @ W`` through the analog
pipeline: quantize x -> input bit planes -> per-(K-partition, slice)
analog dot products -> differential subtraction -> ADC -> shift-and-add
-> exact affine correction -> dequantize, with the dot products optionally
through the parasitic bit-line circuit (``r_hat != 0``, paper Sec. 8).
With ``AnalogSpec.fused`` set, the differential calibrated chain runs as
one hand-written CUDA kernel launch per call
(``repro_torch.kernels.ops.fused_mvm`` / ``fused_mvm_parasitic``); the
legacy ``use_pallas`` route runs the unsliced Design-A kernels
(``ops.analog_mvm`` / ``analog_mvm_parasitic``) and, under parasitics, the
bit-line kernel (``ops.bitline_mvm``) in the composed chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import adc as adc_lib
from repro_torch.core import parasitics
from repro_torch.core.errors import (DriftModel, ErrorModel, FaultModel,
                                     fold_seed, generator)
from repro_torch.core.mapping import (
    MappingConfig,
    ProgrammedCodes,
    codes_to_weights,
    program_int_codes,
)
from repro_torch.core.quant import (
    bit_planes,
    n_input_planes,
    quantize_acts,
    quantize_weights,
)

@dataclasses.dataclass(frozen=True)
class AnalogSpec:
    """Full static description of one analog core design point."""

    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    adc: adc_lib.ADCConfig = dataclasses.field(default_factory=adc_lib.ADCConfig)
    error: ErrorModel = dataclasses.field(default_factory=ErrorModel)
    input_bits: int = 8
    signed_inputs: bool = True
    input_accum: str = "analog"       # "analog" | "digital"
    max_rows: int = 1152
    r_hat: float = 0.0                # normalized parasitic resistance
    use_pallas: bool = False
    fused: str = "off"                # "off" | "kernel" | "oracle"
    compute_dtype: torch.dtype = torch.float32
    drift: DriftModel = dataclasses.field(default_factory=DriftModel)
    fault: FaultModel = dataclasses.field(default_factory=FaultModel)

    def __post_init__(self):
        if self.input_accum not in ("analog", "digital"):
            raise ValueError(
                f"AnalogSpec.input_accum must be 'analog' or 'digital', "
                f"got {self.input_accum!r}")
        if self.fused not in ("off", "kernel", "oracle"):
            raise ValueError(
                f"AnalogSpec.fused must be 'off', 'kernel' or 'oracle', "
                f"got {self.fused!r}")
        if self.input_bits < 1:
            raise ValueError(
                f"AnalogSpec.input_bits must be >= 1, got {self.input_bits}")
        if self.max_rows < 1:
            raise ValueError(
                f"AnalogSpec.max_rows must be >= 1, got {self.max_rows}")

    @property
    def parasitics_on(self) -> bool:
        """Is the bit-line solve part of the program?  True iff ``r_hat``
        is nonzero."""
        return float(self.r_hat) != 0.0

    @property
    def aging_on(self) -> bool:
        return self.drift.kind != "none" or self.fault.kind != "none"

    @property
    def n_planes(self) -> int:
        return n_input_planes(self.input_bits, self.signed_inputs)

    def n_partitions(self, k: int) -> int:
        return max(1, math.ceil(k / self.max_rows))

    def rows_per_partition(self, k: int) -> int:
        return math.ceil(k / self.n_partitions(k))

    def fpg_adc_bits(self, k: int) -> int:
        """Eq. (4)/(5) resolution for this design at matrix depth ``k``."""
        signed_out = (
            self.mapping.scheme == "differential" or self.signed_inputs
        )
        bw = self.mapping.cell_bits + (1 if signed_out else 0)
        bin_eff = self.input_bits if self.input_accum == "analog" else 1
        return adc_lib.fpg_bits(bw, bin_eff, self.rows_per_partition(k))

    def adc_conversions_per_mvm(self, k: int, n: int) -> int:
        """ADC quantizations for one full-precision MVM (Sec. 2.2/9)."""
        per_bit = 1 if self.input_accum == "analog" else self.n_planes
        return self.n_partitions(k) * self.mapping.n_slices * per_bit * n


def design_a(error: Optional[ErrorModel] = None, **kw) -> AnalogSpec:
    """Paper Design A — the recommended configuration (Table 3)."""
    return AnalogSpec(
        mapping=MappingConfig(scheme="differential", weight_bits=8,
                              bits_per_cell=None, on_off_ratio=1e4),
        adc=adc_lib.ADCConfig(style="calibrated", bits=8),
        error=error or ErrorModel(),
        input_accum="analog",
        max_rows=1152,
        **kw,
    )


def design_e(error: Optional[ErrorModel] = None, **kw) -> AnalogSpec:
    """Paper Design E — the ISAAC-like offset/FPG baseline (Table 3)."""
    return AnalogSpec(
        mapping=MappingConfig(scheme="offset", weight_bits=8, bits_per_cell=2),
        adc=adc_lib.ADCConfig(style="calibrated", bits=8),
        error=error or ErrorModel(),
        input_accum="digital",
        max_rows=72,
        **kw,
    )


@dataclasses.dataclass(frozen=True)
class AnalogWeights:
    """Programmed conductances + dequantization scale for one matrix,
    ``g_*`` shaped ``(S, P, rows, N)``; a layer-stacked pack carries a
    leading ``L`` axis on every tensor (see :meth:`layer`)."""

    g_pos: torch.Tensor
    g_neg: Optional[torch.Tensor]
    g_unit: Optional[torch.Tensor]
    w_scale: torch.Tensor
    k: int
    n: int

    def layer(self, i: int) -> "AnalogWeights":
        """Layer ``i`` of a layer-stacked stack (views, no copy)."""
        return AnalogWeights(
            g_pos=self.g_pos[i],
            g_neg=None if self.g_neg is None else self.g_neg[i],
            g_unit=None if self.g_unit is None else self.g_unit[i],
            w_scale=self.w_scale[i], k=self.k, n=self.n)


def _partition(arr: torch.Tensor, k: int, p: int, rows: int) -> torch.Tensor:
    """(S, K, N) -> (S, P, rows, N), zero-padding K to P*rows."""
    s, _, n = arr.shape
    pad = p * rows - k
    if pad:
        arr = torch.nn.functional.pad(arr, (0, 0, 0, pad))
    return arr.reshape(s, p, rows, n)


@dataclasses.dataclass(frozen=True)
class ProgrammedMatrix:
    """Deterministic half of :func:`program`: integer code stacks + the
    weight quantization scale."""

    codes: ProgrammedCodes
    w_scale: torch.Tensor
    k: int
    n: int


def program_codes(w: torch.Tensor, spec: AnalogSpec) -> ProgrammedMatrix:
    """Quantize + map a float weight matrix ``(K, N)`` to integer codes."""
    if w.ndim != 2:
        raise ValueError(
            f"program_codes expects a 2-D (K, N) weight matrix, got shape "
            f"{tuple(w.shape)}")
    k, n = w.shape
    m = spec.mapping
    mag_bits = None if m.scheme == "offset" else m.magnitude_bits
    qt = quantize_weights(w.float(), m.weight_bits, magnitude_bits=mag_bits)
    pc = program_int_codes(qt.values.to(torch.int32), m)
    return ProgrammedMatrix(codes=pc, w_scale=qt.scale.float(), k=k, n=n)


def program_from_codes(pm: ProgrammedMatrix, spec: AnalogSpec,
                       seed: Optional[int] = None) -> AnalogWeights:
    """Conductance-convert + partition + perturb cached code stacks.

    Programming noise for the positive, negative and unit lines comes
    from three generators folded from ``seed``; ``None`` programs
    error-free.  Aging at the spec's own ages (``spec.drift.t``,
    ``spec.fault.t``) follows, seeded by ``fold_seed(seed, _AGE_FOLD)``,
    on the partitioned stacks (padded rows included), so the noise draws
    do not depend on whether aging is on.
    """
    k, n = pm.k, pm.n
    pw = codes_to_weights(pm.codes, spec.mapping)
    p = spec.n_partitions(k)
    rows = spec.rows_per_partition(k)
    lines = [None if g is None else _partition(g, k, p, rows)
             for g in (pw.g_pos, pw.g_neg, pw.g_unit)]
    if spec.error.kind != "none" and seed is not None:
        lines = [None if g is None else spec.error.perturb(
                     g, generator(fold_seed(seed, i), g.device))
                 for i, g in enumerate(lines)]
    if spec.aging_on and seed is not None:
        lines = age_conductances(*lines, spec, fold_seed(seed, _AGE_FOLD))
    dt = spec.compute_dtype
    g_pos, g_neg, g_unit = (None if g is None else g.to(dt) for g in lines)
    return AnalogWeights(g_pos=g_pos, g_neg=g_neg, g_unit=g_unit,
                         w_scale=pm.w_scale, k=k, n=n)


#: fold tag of the aging seed (the reference's "age"); disjoint from the
#: three programming-noise folds 0, 1, 2
_AGE_FOLD = 0x616765


def age_conductances(
    g_pos: torch.Tensor,
    g_neg: Optional[torch.Tensor],
    g_unit: Optional[torch.Tensor],
    spec: AnalogSpec,
    seed: int,
    *,
    t_drift=None,
    t_fault=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Apply ``spec.drift`` then ``spec.fault`` to a conductance stack.

    Drift decays the programmed (noise-perturbed) values; faults then pin
    cells whatever was programmed into them.  One stream per line, folded
    from ``seed``.  ``t_drift``/``t_fault`` default to the spec's own ages;
    the healer passes them per band (``repro_torch.serve.health``: drift
    restarts at each reprogram, faults accumulate in absolute time).  At
    ``t = 1`` both passes return values equal to their inputs.
    """
    td = spec.drift.t if t_drift is None else t_drift
    tf = spec.fault.t if t_fault is None else t_fault
    sd, sf = fold_seed(seed, "drift"), fold_seed(seed, "fault")
    gs = [g_pos, g_neg, g_unit]
    if spec.drift.kind != "none":
        gs = [None if g is None else spec.drift.apply(g, td, fold_seed(sd, i))
              for i, g in enumerate(gs)]
    if spec.fault.kind != "none":
        gs = [None if g is None else spec.fault.apply(
                  g, tf, fold_seed(sf, i), g_lo=spec.mapping.g_min, g_hi=1.0)
              for i, g in enumerate(gs)]
    return gs[0], gs[1], gs[2]


def program(w: torch.Tensor, spec: AnalogSpec,
            seed: Optional[int] = None) -> AnalogWeights:
    """Quantize + map + perturb a float weight matrix ``(K, N)``."""
    return program_from_codes(program_codes(w, spec), spec, seed)


def _apply_line(planes: torch.Tensor, g: torch.Tensor,
                spec: AnalogSpec) -> torch.Tensor:
    """Per-plane analog dot products: (B, M, P, rows) x (S, P, rows, N)
    -> (B, S, P, M, N), in float32 (TF32 is off package-wide); under
    parasitics each plane's bottom currents through every (slice,
    partition) array."""
    if not spec.parasitics_on:
        return torch.einsum("bmpr,sprn->bspmn", planes, g)
    b, m_, p, rows = planes.shape
    s, _, _, n = g.shape
    if spec.use_pallas:
        # the bit-line kernel, bit planes folded into its plane rows: one
        # launch covers every (slice, partition) array
        from repro_torch.kernels import ops as kops

        xp = planes.permute(2, 0, 1, 3).reshape(p, b * m_, rows)
        out = kops.bitline_mvm(g.reshape(s * p, rows, n), xp, spec.r_hat)
        return out.reshape(s, p, b, m_, n).permute(2, 0, 1, 3, 4)
    return parasitics.bottom_current(planes.permute(0, 2, 1, 3)[:, None],
                                     g[None], spec.r_hat)


def _maybe_pallas_fastpath(spec: AnalogSpec, collect: bool) -> bool:
    """Kernel-eligibility predicate for the differential calibrated chain,
    unchanged from the reference: ``fused != "off"`` selects the fused
    serving kernels for both input-accumulation modes (digital
    accumulation under parasitics has no fused form); calibration
    collection, non-differential and non-calibrated designs compose;
    legacy ``use_pallas`` keeps its narrower unsliced Design-A domain."""
    if (
        collect
        or spec.mapping.scheme != "differential"
        or spec.adc.style != "calibrated"
    ):
        return False
    if spec.fused != "off":
        return spec.input_accum == "analog" or not spec.parasitics_on
    return (
        spec.use_pallas
        and not spec.mapping.sliced
        and spec.input_accum == "analog"
    )


def fuse_signature(spec: AnalogSpec) -> Optional[Tuple]:
    """The static identity of a spec's fused serving kernel (``None``
    means the spec composes), unchanged from the reference."""
    if spec.fused == "off" or not _maybe_pallas_fastpath(spec, False):
        return None
    m = spec.mapping
    n_bits = None if spec.input_accum == "analog" else spec.n_planes
    return (
        "parasitic" if spec.parasitics_on else "linear",
        m.n_slices, m.cell_bits, spec.adc.bits, n_bits,
        spec.n_planes if spec.parasitics_on else None,
    )


def analog_matmul(
    x: torch.Tensor,
    aw: AnalogWeights,
    spec: AnalogSpec,
    *,
    adc_lo: Optional[torch.Tensor] = None,   # (S,) calibrated limits
    adc_hi: Optional[torch.Tensor] = None,
    act_hi: Optional[torch.Tensor] = None,   # calibrated activation clip
    collect: bool = False,
):
    """Simulated analog ``x @ W`` for ``x`` of shape ``(..., K)``.

    Returns ``y`` of shape ``(..., N)``; with ``collect=True`` returns
    ``(y_ideal, stats)`` with ``stats`` the ``(S, 2)`` pre-ADC lo/hi
    percentiles for ADC range calibration (ADC bypassed).
    """
    m = spec.mapping
    lead = x.shape[:-1]
    k = x.shape[-1]
    if k != aw.k:
        raise ValueError(
            f"analog_matmul input depth {k} does not match the programmed "
            f"matrix depth {aw.k} (weights are ({aw.k}, {aw.n}))")
    xf = x.reshape(-1, k).to(spec.compute_dtype)

    xq = quantize_acts(xf, spec.input_bits, signed=spec.signed_inputs,
                       clip_hi=act_hi)
    p = spec.n_partitions(k)
    rows = spec.rows_per_partition(k)
    pad = p * rows - k
    x_int = xq.values
    if pad:
        x_int = torch.nn.functional.pad(x_int, (0, pad))
    x_parts = x_int.reshape(-1, p, rows)

    lmax = m.levels_per_cell - 1
    gain = lmax / (1.0 - m.g_min)          # conductance -> code units
    slice_w = 2.0 ** (m.cell_bits * torch.arange(
        m.n_slices, dtype=xf.dtype, device=x.device))

    if _maybe_pallas_fastpath(spec, collect) and adc_lo is not None:
        from repro_torch.kernels import ops as kops

        if spec.fused != "off":
            # whole-chain fused kernels: ADC, dequant and slice
            # accumulation inside the launch
            backend = "oracle" if spec.fused == "oracle" else "kernel"
            scale = gain * aw.w_scale * xq.scale
            if spec.parasitics_on:
                y = kops.fused_mvm_parasitic(
                    x_parts, aw.g_pos, aw.g_neg, r_hat=spec.r_hat,
                    adc_lo=adc_lo, adc_hi=adc_hi, adc_bits=spec.adc.bits,
                    cell_bits=m.cell_bits, n_bits=spec.n_planes, scale=scale,
                    backend=backend)
            else:
                n_bits = None if spec.input_accum == "analog" \
                    else spec.n_planes
                y = kops.fused_mvm(
                    x_parts, aw.g_pos, aw.g_neg, adc_lo=adc_lo,
                    adc_hi=adc_hi, adc_bits=spec.adc.bits,
                    cell_bits=m.cell_bits, n_bits=n_bits, scale=scale,
                    backend=backend)
            return y.reshape(*lead, aw.n)

        # the legacy use_pallas route: unsliced Design A, epilogue in
        # code units inside the kernel
        if spec.parasitics_on:
            d_codes = kops.analog_mvm_parasitic(
                x_parts, aw.g_pos, aw.g_neg, r_hat=spec.r_hat,
                n_bits=spec.n_planes, adc_lo=adc_lo, adc_hi=adc_hi,
                adc_bits=spec.adc.bits, gain=gain)
        else:
            d_codes = kops.analog_mvm(
                x_parts, aw.g_pos, aw.g_neg, adc_lo=adc_lo, adc_hi=adc_hi,
                adc_bits=spec.adc.bits, gain=gain)
        y = d_codes * aw.w_scale * xq.scale
        return y.reshape(*lead, aw.n)

    if spec.input_accum == "analog" and not spec.parasitics_on:
        # analog accumulation over input bits commutes with the dot
        # product: one matmul per (slice, partition)
        planes = x_parts[None]                                # (1, M, P, rows)
        bit_w = torch.ones(1, dtype=xf.dtype, device=x.device)
    else:
        nb = spec.n_planes
        planes = bit_planes(x_int, nb, signed=spec.signed_inputs)
        planes = planes.reshape(nb, -1, p, rows)              # (B, M, P, rows)
        bit_w = 2.0 ** torch.arange(nb, dtype=xf.dtype, device=x.device)

    v_pos = _apply_line(planes, aw.g_pos, spec)               # (B, S, P, M, N)
    if m.scheme == "differential":
        v = v_pos - _apply_line(planes, aw.g_neg, spec)       # analog subtract
    else:
        v = v_pos
    if spec.input_accum == "analog" and spec.parasitics_on:
        # the solve is per input bit; analog accumulation happens in the
        # switched-capacitor stage after the bit line, before the ADC
        # (bits ascending from the first, the fused kernels' fold order)
        acc = v[0]
        for b in range(1, v.shape[0]):
            acc = acc + v[b] * bit_w[b]
        v = acc[None]
        bit_w = torch.ones(1, dtype=xf.dtype, device=x.device)
        s_b = x_parts.sum(dim=-1)[None]                       # (1, M, P)
    else:
        s_b = planes.sum(dim=-1)                              # (B, M, P)

    if collect:
        stats = torch.stack([
            torch.stack(adc_lib.range_from_samples(v[:, s]))
            for s in range(m.n_slices)
        ])                                                    # (S, 2)
        v_hat = v
    elif spec.adc.style == "none":
        v_hat = v
    elif spec.adc.style == "fpg":
        bits = spec.fpg_adc_bits(k)
        lo, hi = adc_lib.fpg_range(
            rows, 1.0, signed_inputs=spec.signed_inputs,
            differential=(m.scheme == "differential"))
        if spec.input_accum == "analog":
            scale_in = float(2 ** (spec.input_bits - 1) - 1
                             if spec.signed_inputs else 2 ** spec.input_bits - 1)
            lo, hi = lo * scale_in, hi * scale_in
        # snap the LSB to the exact analog output grid (Eq. 4 guarantees
        # 2**bits levels cover the full range)
        grid = (1.0 - m.g_min) / lmax
        lo = grid * math.floor(lo / grid)
        hi = lo + (2 ** bits - 1) * grid
        v_hat = adc_lib.adc_quantize(v, lo, hi, bits)
    else:
        if adc_lo is None or adc_hi is None:
            raise ValueError(
                "adc.style='calibrated' requires adc_lo/adc_hi ranges from "
                "the calibration pass (analog_matmul(..., collect=True) or "
                "core.calibrate.calibrate_adc_for_matmul)")
        lo = adc_lo.reshape(1, m.n_slices, 1, 1, 1).to(v.dtype)
        hi = adc_hi.reshape(1, m.n_slices, 1, 1, 1).to(v.dtype)
        v_hat = adc_lib.adc_quantize(v, lo, hi, spec.adc.bits)

    # ---- digital aggregation + exact affine corrections -----------------
    if m.scheme == "differential":
        codes = v_hat * gain                                  # g_min cancels
        d = torch.einsum("s,b,bspmn->mn", slice_w, bit_w, codes)
    elif m.unit_column:
        vu = _apply_line(planes, aw.g_unit, spec)             # (B, S, P, M, 1)
        if not collect and spec.adc.style != "none":
            vu = adc_lib.adc_quantize(
                vu, lo, hi, bits if spec.adc.style == "fpg" else spec.adc.bits)
        codes = (v_hat - vu) * gain                           # analog offset
        d = torch.einsum("s,b,bspmn->mn", slice_w, bit_w, codes)
    else:
        # g_min floor correction from the exact digital sum of input bits
        s_bp = s_b.transpose(1, 2)                            # (B, P, M)
        codes = (v_hat - m.g_min * s_bp[:, None, :, :, None]) * gain
        d = torch.einsum("s,b,bspmn->mn", slice_w, bit_w, codes)
        x_sum = xq.values.sum(dim=-1)                         # (M,)
        d = d - m.offset_code * x_sum[:, None]

    y = (d * aw.w_scale * xq.scale).reshape(*lead, aw.n)
    if collect:
        return y, stats
    return y
