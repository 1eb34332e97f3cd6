"""Weight -> conductance mapping schemes (paper Sec. 2.1, 2.3, 4.1, Fig. 4);
counterpart of ``repro.core.mapping``.

Two axes of the design space: ``offset`` subtraction versus
``differential`` cell pairs, and bit-sliced (1/2/4/8 bits per cell,
shift-and-add) versus unsliced cells.  Conductances are normalized,
``g = G / G_max`` in ``[0, 1]``; a finite On/Off ratio maps the code
range onto ``[g_min, 1]`` and the periphery corrects that affine map
exactly, so in the error-free limit every scheme reproduces the integer
dot product.  Integer conventions are the reference's (see ``quant``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.quant import true_div


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Static description of one point in the mapping design space."""

    scheme: str = "differential"          # "differential" | "offset"
    weight_bits: int = 8                  # signed weight precision B
    bits_per_cell: Optional[int] = None   # None => unsliced
    on_off_ratio: float = float("inf")    # G_max / G_min
    unit_column: bool = False             # analog offset column (offset only)

    def __post_init__(self):
        if self.scheme not in ("differential", "offset"):
            raise ValueError(
                f"MappingConfig.scheme must be 'differential' or 'offset', "
                f"got {self.scheme!r}")
        if self.bits_per_cell is not None and self.bits_per_cell not in (1, 2, 4, 8):
            raise ValueError(
                f"MappingConfig.bits_per_cell must be None (unsliced) or "
                f"one of (1, 2, 4, 8), got {self.bits_per_cell!r}")
        if self.unit_column and self.scheme != "offset":
            raise ValueError(
                "MappingConfig.unit_column=True only applies to the "
                f"'offset' scheme, got scheme={self.scheme!r}")

    @property
    def sliced(self) -> bool:
        return self.bits_per_cell is not None

    @property
    def cell_bits(self) -> int:
        """Bits stored per memory cell."""
        if self.sliced:
            return self.bits_per_cell
        # unsliced: offset stores all B bits, differential the magnitude
        return self.weight_bits if self.scheme == "offset" else self.weight_bits - 1

    @property
    def n_slices(self) -> int:
        if not self.sliced:
            return 1
        total = self.weight_bits if self.scheme == "offset" else self.weight_bits - 1
        return math.ceil(total / self.bits_per_cell)

    @property
    def magnitude_bits(self) -> int:
        """Total magnitude bits (differential) or total bits (offset)."""
        if self.scheme == "offset":
            return self.n_slices * self.cell_bits if self.sliced else self.weight_bits
        return self.n_slices * self.cell_bits if self.sliced else self.weight_bits - 1

    @property
    def levels_per_cell(self) -> int:
        return 2 ** self.cell_bits

    @property
    def g_min(self) -> float:
        """``1 / on_off_ratio`` (0 for an infinite On/Off ratio)."""
        return 0.0 if math.isinf(self.on_off_ratio) else 1.0 / self.on_off_ratio

    @property
    def cells_per_weight(self) -> int:
        return self.n_slices * (2 if self.scheme == "differential" else 1)

    @property
    def offset_code(self) -> int:
        """Code added to w_int under offset subtraction (2**(B-1))."""
        return 2 ** (self.weight_bits - 1)


# ---------------------------------------------------------------------------
# bit slicing
# ---------------------------------------------------------------------------


def slice_codes(codes: torch.Tensor, bits_per_cell: int,
                n_slices: int) -> torch.Tensor:
    """Split non-negative integer ``codes`` into ``n_slices`` slices of
    ``bits_per_cell`` bits, least-significant first: shape
    ``(n_slices,) + codes.shape``."""
    c = codes.to(torch.int32)
    mask = (1 << bits_per_cell) - 1
    out = [((c >> (bits_per_cell * s)) & mask).to(codes.dtype)
           for s in range(n_slices)]
    return torch.stack(out, dim=0)


def unslice_codes(slices: torch.Tensor, bits_per_cell: int) -> torch.Tensor:
    """Inverse of :func:`slice_codes`: the shift-and-add reduction
    ``sum_s 2**(bpc*s) * slices[s]``, slices ascending (every weight a
    power of two, so each product is exact)."""
    out = slices[0]
    for s in range(1, slices.shape[0]):
        out = out + slices[s] * (2 ** (bits_per_cell * s))
    return out


# ---------------------------------------------------------------------------
# code -> conductance
# ---------------------------------------------------------------------------


def codes_to_conductance(codes: torch.Tensor, cfg: MappingConfig) -> torch.Tensor:
    """``g = g_min + (1 - g_min) * code / (L - 1)`` (Fig. 4), evaluated
    in the reference's order so conductances match it bit for bit."""
    lmax = cfg.levels_per_cell - 1
    return cfg.g_min + true_div((1.0 - cfg.g_min) * codes.to(torch.float32),
                                lmax)


def conductance_to_codes(g: torch.Tensor, cfg: MappingConfig) -> torch.Tensor:
    """Exact affine inverse of :func:`codes_to_conductance` (the digital
    periphery knows the programmed transfer curve), in the reference's
    order: ``(g - g_min) * (L - 1) / (1 - g_min)``."""
    lmax = cfg.levels_per_cell - 1
    return true_div((g - cfg.g_min) * lmax, 1.0 - cfg.g_min)


@dataclasses.dataclass(frozen=True)
class ProgrammedWeights:
    """Conductance stacks ``(n_slices, K, N)`` of one weight matrix;
    ``g_neg`` for differential, ``g_unit`` (``(n_slices, K, 1)``) for an
    offset unit column."""

    g_pos: torch.Tensor
    g_neg: Optional[torch.Tensor]
    g_unit: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ProgrammedCodes:
    """Integer cell-code stacks in ``[0, L-1]`` (the g_min-independent
    half of programming), laid out like :class:`ProgrammedWeights`."""

    c_pos: torch.Tensor
    c_neg: Optional[torch.Tensor]
    c_unit: Optional[torch.Tensor]


def program_int_codes(w_int: torch.Tensor, cfg: MappingConfig) -> ProgrammedCodes:
    """Map signed integer weights (int32) to cell-code stacks."""
    if cfg.scheme == "offset":
        prog = w_int + cfg.offset_code                       # strictly >= 0
        slices = (slice_codes(prog, cfg.cell_bits, cfg.n_slices)
                  if cfg.sliced else prog[None])
        c_unit = None
        if cfg.unit_column:
            unit = torch.full((w_int.shape[0], 1), cfg.offset_code,
                              dtype=torch.int32, device=w_int.device)
            c_unit = (slice_codes(unit, cfg.cell_bits, cfg.n_slices)
                      if cfg.sliced else unit[None])
        return ProgrammedCodes(c_pos=slices, c_neg=None, c_unit=c_unit)

    # differential: sign-magnitude; one line of each pair stays at code 0
    mag = w_int.abs()
    zero = torch.zeros_like(mag)
    pos = torch.where(w_int > 0, mag, zero)
    neg = torch.where(w_int < 0, mag, zero)
    if cfg.sliced:
        sp = slice_codes(pos, cfg.cell_bits, cfg.n_slices)
        sn = slice_codes(neg, cfg.cell_bits, cfg.n_slices)
    else:
        sp, sn = pos[None], neg[None]
    return ProgrammedCodes(c_pos=sp, c_neg=sn, c_unit=None)


def codes_to_weights(pc: ProgrammedCodes, cfg: MappingConfig) -> ProgrammedWeights:
    """Convert code stacks to conductance stacks."""
    def conv(c):
        return None if c is None else codes_to_conductance(c, cfg)
    return ProgrammedWeights(g_pos=conv(pc.c_pos), g_neg=conv(pc.c_neg),
                             g_unit=conv(pc.c_unit))


def program_weights(w_int: torch.Tensor, cfg: MappingConfig) -> ProgrammedWeights:
    """Map signed integer weights (int32) to conductance stacks
    (error-free)."""
    return codes_to_weights(program_int_codes(w_int, cfg), cfg)


def reconstruct_weights(pw: ProgrammedWeights,
                        cfg: MappingConfig) -> torch.Tensor:
    """Recover signed integer weights from (possibly perturbed)
    conductances: the ideal decoder the digital periphery implements."""
    cp = conductance_to_codes(pw.g_pos, cfg)
    if cfg.scheme == "offset":
        codes = unslice_codes(cp, cfg.cell_bits) if cfg.sliced else cp[0]
        return codes - cfg.offset_code
    cn = conductance_to_codes(pw.g_neg, cfg)
    if cfg.sliced:
        return (unslice_codes(cp, cfg.cell_bits)
                - unslice_codes(cn, cfg.cell_bits))
    return cp[0] - cn[0]


def average_conductance(pw: ProgrammedWeights) -> torch.Tensor:
    """Per-slice mean normalized conductance (paper Fig. 6), summed in
    float64 and rounded once to the conductances' dtype."""
    gs = [pw.g_pos] + ([pw.g_neg] if pw.g_neg is not None else [])
    stacked = torch.cat([g.reshape(g.shape[0], -1) for g in gs], dim=-1)
    return stacked.double().mean(dim=-1).to(stacked.dtype)
