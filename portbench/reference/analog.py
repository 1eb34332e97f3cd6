"""The analog chain of one design point, written out plainly from the
paper's definitions: Design A (differential cell pairs, one cell a sign,
unsliced), a calibrated ADC per array, analog accumulation of the input
bits, and optionally the bit line's wire resistance (Sec. 8).

Programming a weight matrix W (K, N):

1. ``w_int = clamp(round(W / s_w), -127, 127)`` with ``s_w = max|W| / 127``;
2. the positive part goes to one cell of a pair and the negative part to
   the other, as codes c in [0, 127], each cell at conductance
   ``g = g_min + (1 - g_min) c / 127`` (``g_min`` = 1 / on-off ratio);
3. K is split into ``P = ceil(K / max_rows)`` arrays of ``ceil(K / P)``
   rows, the last padded with empty rows (g = 0);
4. each line gets its programming error, ``g + alpha g z`` with z drawn
   from the chip's seed (state-proportional).

An MVM quantizes the input rows to signed 8-bit integers against a
clip, takes each array's output ``v = x_int . (g_pos - g_neg)`` (or, under
wire resistance, ``sum_b 2**b (I_pos,b - I_neg,b)`` over the input's
signed bit planes, each current the bottom node's of a resistive ladder),
passes it through the ADC's ``2**bits`` levels between the array's
calibrated limits, sums the arrays and scales back by ``127 / (1 - g_min)
* s_w * s_x``.  Calibration takes the clip as the L1-optimal one of 32
candidates and the ADC limits as the inner 99.98% of the observed
``v``.

Everything is float32; matrix products run with TF32 off.  The model's
outputs move by whole ADC levels where a value sits at a level's edge,
and one such move changes everything downstream, so the arithmetic is
spelled out in a fixed order: an array's dot sums its rows in ascending
order, one rounded multiply and one rounded add a row, as the paper's
kernels define it; the arrays are summed in ascending order; the
dequantization is taken in ADC code units with one final scale on the
fused route (``fused`` set) and in value units times the gain, then the
weight and input scales, on the others; the percentile's fractional rank
and the clip candidates are the float32 values the calibration defines.
``lower=True`` is the control: the operands of every array product and
bit-line solve rounded to TF32 (10 mantissa bits)."""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional, Tuple

import numpy as np
import torch

#: fields of a design object that choose the port's route: ``fused``
#: also fixes the order of the dequantization (see the module's text)
ROUTES = ("fused", "use_pallas")
#: share of the observed pre-ADC values inside the calibrated ADC range
COVERAGE = 0.9998
#: largest number of floats one bit-line temporary holds
SOLVE_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class Design:
    """Design A's parameters that a design point can set."""

    error: str = "none"           # none | state_proportional | state_independent
    alpha: float = 0.0
    adc_bits: int = 8
    r_hat: float = 0.0            # wire resistance x G_max; 0 is ideal
    weight_bits: int = 8          # signed; magnitude 7 bits a cell
    input_bits: int = 8           # signed; 7 magnitude bit planes
    on_off: float = 1e4
    max_rows: int = 1152
    code_units: bool = False      # the fused route's dequantization order

    @property
    def q_w(self) -> int:
        return 2 ** (self.weight_bits - 1) - 1

    @property
    def q_x(self) -> int:
        return 2 ** (self.input_bits - 1) - 1

    @property
    def g_min(self) -> float:
        return 1.0 / self.on_off

    @property
    def gain(self) -> float:
        """Conductance difference to weight code."""
        return self.q_w / (1.0 - self.g_min)

    def arrays(self, k: int) -> Tuple[int, int]:
        """(number of arrays, rows an array) for depth ``k``."""
        p = max(1, math.ceil(k / self.max_rows))
        return p, math.ceil(k / p)


def design(desc: dict) -> Design:
    """The Design of a traffic file's design object::

        {"preset": "design_a", "error": {"kind": ..., "alpha": ...},
         "fields": {"adc.bits": 6, "r_hat": 1e-4, "fused": "kernel"}}

    Fields that only pick the port's route are ignored; any other field
    the reference does not model is refused."""
    if desc.get("preset", "design_a") != "design_a":
        raise ValueError(f"the reference models design_a only, not "
                         f"{desc.get('preset')!r}")
    err = dict(desc.get("error") or {})
    kind = err.pop("kind", "none")
    alpha = float(err.pop("alpha", 0.0))
    if err or kind not in ("none", "state_proportional",
                           "state_independent"):
        raise ValueError(f"the reference has no error model {desc['error']}")
    kw = {}
    for path, value in desc.get("fields", {}).items():
        if path == "fused":
            kw["code_units"] = value != "off"
        elif path in ROUTES:
            continue
        elif path == "adc.bits":
            kw["adc_bits"] = int(value)
        elif path == "r_hat":
            kw["r_hat"] = float(value)
        else:
            raise ValueError(f"the reference has no design field {path!r}")
    return Design(error=kind, alpha=alpha, **kw)


# ---------------------------------------------------------------------------
# seeds: how a chip's programming noise is drawn from its seed
# ---------------------------------------------------------------------------

def fold(seed: int, data) -> int:
    """A 63-bit seed from ``seed`` and ``data``: blake2s of
    ``"<seed>/<data>"``, 8 bytes, big-endian."""
    h = hashlib.blake2s(f"{int(seed)}/{data}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") & 0x7FFFFFFFFFFFFFFF


def site_seed(seed: int, name: str) -> int:
    """The seed of a projection site: ``seed`` folded with the 31-bit
    blake2s hash of its name.  Layer ``i`` of the site draws from
    ``fold(site_seed, i)``; the lm_head from the site seed itself."""
    h = hashlib.blake2s(name.encode(), digest_size=4).digest()
    return fold(seed, int.from_bytes(h, "big") & 0x7FFFFFFF)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties to
    even (the operand rounding of a TF32 matrix product)."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0xFFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


@dataclasses.dataclass
class Array:
    """One programmed weight matrix: both lines (P, rows, N) and the
    weight scale."""

    g_pos: torch.Tensor
    g_neg: torch.Tensor
    w_scale: torch.Tensor
    k: int


def program(w: torch.Tensor, d: Design, seed: Optional[int]) -> Array:
    """Program ``w`` (K, N); ``seed`` None programs without error."""
    k, n = w.shape
    w = w.float()
    s_w = div(w.abs().amax().clamp(min=1e-12), d.q_w)
    w_int = torch.clamp(torch.round(w / s_w), -d.q_w, d.q_w)
    p, rows = d.arrays(k)
    lines = []
    for i, code in enumerate((w_int.clamp(min=0), (-w_int).clamp(min=0))):
        g = d.g_min + div((1.0 - d.g_min) * code, d.q_w)
        g = torch.nn.functional.pad(g, (0, 0, 0, p * rows - k))
        g = g.reshape(p, rows, n)
        if d.error != "none" and seed is not None:
            gen = torch.Generator(device=w.device).manual_seed(fold(seed, i))
            z = torch.randn(g.shape, generator=gen, dtype=torch.float32,
                            device=w.device)
            sigma = d.alpha * g if d.error == "state_proportional" \
                else torch.full_like(g, d.alpha)
            g = g + sigma * z
        lines.append(g)
    return Array(g_pos=lines[0], g_neg=lines[1], w_scale=s_w, k=k)


def quantize(x: torch.Tensor, clip: Optional[torch.Tensor], q: int):
    """Signed ``q``-level integers of ``x`` against ``clip`` (its max |x|
    when None) and their scale."""
    top = x.abs().amax() if clip is None else clip.abs()
    scale = div(top.clamp(min=1e-12), q)
    return torch.clamp(torch.round(x / scale), -q, q), scale


#: the 32 clip candidates as fractions of max |x|: exp(linspace(log
#: 2**-6, 0, 32)) as the calibration evaluates it in float32, op by op
#: (its bits; an ulp here is an ulp in every input scale)
CLIP_FRACTIONS = (
    0x3c800000, 0x3c926096, 0x3ca764a6, 0x3cbf6d24, 0x3cdae8f2, 0x3cfa56e3,
    0x3d0f2405, 0x3d23b11d, 0x3d3b318d, 0x3d5611c8, 0x3d74cdd8, 0x3d8bf9c6,
    0x3da01288, 0x3db70def, 0x3dd1560c, 0x3def6423, 0x3e08e16e, 0x3e1c886e,
    0x3e3301bf, 0x3e4cb518, 0x3e6a190a, 0x3e85da9c, 0x3e991260, 0x3eaf0c7c,
    0x3ec82e56, 0x3ee4ebeb, 0x3f02e4ee, 0x3f15afe7, 0x3f2b2d9a, 0x3f43c133,
    0x3f5fdc1a, 0x3f800000,
)


def _fractions(device) -> torch.Tensor:
    bits = torch.tensor(CLIP_FRACTIONS, dtype=torch.int64).to(torch.int32)
    return bits.view(torch.float32).to(device)


def act_clip(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """The L1-optimal clip of ``x`` (Sec. 4.3): of 32 candidates between
    max|x| / 64 and max|x|, each tried as snapped to a 4096-step grid of
    max|x|, the one whose quantization error has the least L1 norm."""
    flat = x.reshape(-1).float()
    top = flat.abs().amax().clamp(min=1e-12)
    cands = top * _fractions(flat.device)
    snapped = torch.round(cands / top * 4096.0) / 4096.0 * top
    q = 2 ** (bits - 1) - 1
    errs = []
    for c in snapped:
        xi, s = quantize(flat, c, q)
        errs.append((xi * s - flat).abs().sum())
    return cands[int(torch.argmin(torch.stack(errs)))]


def percentile(sorted_flat: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of sorted values, linearly interpolated
    between the two nearest ranks (numpy's default), the fractional rank
    ``(q * 0.01) * (n - 1)`` and its weights taken in float32 as the
    calibration takes them."""
    n = sorted_flat.numel()
    pos = (np.float32(q) * np.float32(0.01)) * np.float32(n - 1)
    i = int(min(max(np.floor(pos), 0), n - 1))
    j = int(min(max(np.ceil(pos), 0), n - 1))
    t = np.float32(pos - np.floor(pos))
    return (sorted_flat[i] * float(np.float32(1.0) - t)
            + sorted_flat[j] * float(t))


def adc_range(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inner ``COVERAGE`` of the observed pre-ADC values."""
    s = torch.sort(v.reshape(-1)).values
    tail = (1.0 - COVERAGE) / 2.0 * 100.0
    return percentile(s, tail), percentile(s, 100.0 - tail)


def adc_lsb(lo, hi, bits: int) -> torch.Tensor:
    lsb = div(hi - lo, 2 ** bits - 1)
    return torch.where(lsb <= 0, torch.ones_like(lsb), lsb)


def adc_code(v: torch.Tensor, lo, lsb, bits: int) -> torch.Tensor:
    """The ADC's level: ``v`` clipped to the range and rounded to one of
    ``2**bits`` even steps of ``lsb`` above ``lo``."""
    return torch.clamp(torch.round((v - lo) / lsb), 0, 2 ** bits - 1)


# ---------------------------------------------------------------------------
# array outputs
# ---------------------------------------------------------------------------

def bit_planes(x_int: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) + shape signed bit planes of integers: bit b of |x| carrying
    the sign of x, so ``sum_b 2**b planes[b] == x``."""
    mag = x_int.abs().to(torch.int32)
    sign = torch.sign(x_int)
    return torch.stack([((mag >> b) & 1).to(torch.float32) * sign
                        for b in range(n)])


def ladder_currents(planes: torch.Tensor, g: torch.Tensor,
                    r) -> torch.Tensor:
    """Bottom-node currents of resistive bit lines.

    ``planes`` (B, P, M, rows) in {-1, 0, 1} drive the cells of the line
    stacks ``g`` (L, P, rows, N); the result is (B, L, P, M, N).  Each
    column is a ladder: cell i a conductance g_i from its source x_i
    (switched on where x_i != 0) to node i, neighbouring nodes joined by
    the wire's resistance r (in units of 1 / G_max), the node below the
    last held at ground.  Kirchhoff at node i, times r::

        -v_{i-1} + (2 + |x_i| g_i r) v_i - v_{i+1} = x_i g_i r

    (1 in place of 2 at the top node, which has one wire), and the
    current out of the bottom is v_{K-1} / r: the tridiagonal system's
    forward elimination gives v_{K-1} without the back substitution::

        e_i = (|x_i| g_i r + (1 or 2)) + c_{i-1},  c_i = -1 / e_i,
        d_i = (x_i g_i r + d_{i-1}) / e_i,         v_{K-1} = d_{K-1}

    in that order of operations, ``r`` a float32 number."""
    b_, p, m, rows = planes.shape
    n_lines, _, _, n = g.shape
    if not torch.is_tensor(r):
        r = torch.tensor(float(r), dtype=torch.float32, device=g.device)
    per_col = b_ * n_lines * p * m
    step = max(1, min(n, SOLVE_ELEMS // per_col))
    if step < n:
        return torch.cat([ladder_currents(planes, g[..., j:j + step], r)
                          for j in range(0, n, step)], dim=-1)
    a = planes.abs()[:, None, ..., None]                 # (B, 1, P, M, rows, 1)
    x = planes[:, None, ..., None]
    gr = (g * r)[None, :, :, None]                       # (1, L, P, 1, rows, N)
    c = torch.zeros((b_, n_lines, p, m, n), dtype=torch.float32,
                    device=g.device)
    d = torch.zeros_like(c)
    neg_one = torch.full((), -1.0, dtype=torch.float32, device=g.device)
    for i in range(rows):
        gr_i = gr[..., i, :]
        e = (a[..., i, :] * gr_i).add_(1.0 if i == 0 else 2.0).add_(c)
        c = torch.div(neg_one, e)
        d = torch.addcmul(d, x[..., i, :], gr_i).div_(e)
    return d / r


def pre_adc(x_int: torch.Tensor, arr: Array, d: Design,
            lower: bool = False, by_line: bool = False) -> torch.Tensor:
    """Each array's analog output for integer input rows ``x_int`` (M,
    K): (P, M, N).  Without wire resistance the dot is with ``g_pos -
    g_neg``, rows in ascending order; ``by_line`` takes each line's
    matrix product and subtracts (the calibration's composed chain)."""
    p, rows, n = arr.g_pos.shape
    m = x_int.shape[0]
    xp = torch.nn.functional.pad(x_int, (0, p * rows - arr.k))
    xp = xp.reshape(m, p, rows).permute(1, 0, 2)        # (P, M, rows)
    if d.r_hat == 0.0:
        op = tf32 if lower else (lambda t: t)
        if by_line:
            x4 = xp.permute(1, 0, 2)[None]               # (1, M, P, rows)
            return (torch.einsum("bmpr,sprn->bspmn", x4, op(arr.g_pos)[None])
                    - torch.einsum("bmpr,sprn->bspmn", x4,
                                   op(arr.g_neg)[None]))[0, 0]
        g = op(arr.g_pos - arr.g_neg)
        v = torch.zeros((p, m, n), dtype=torch.float32, device=g.device)
        for r in range(rows):
            v = v + xp[:, :, r:r + 1] * g[:, r:r + 1, :]
        return v
    g = torch.stack([arr.g_pos, arr.g_neg])
    planes = bit_planes(xp, d.input_bits - 1)            # (B, P, M, rows)
    i = ladder_currents(planes, tf32(g) if lower else g, d.r_hat)
    v = None
    for b in range(i.shape[0]):                          # bits ascending
        term = (i[b, 0] - i[b, 1]) * 2.0 ** b
        v = term if v is None else v + term
    return v


def matmul(x: torch.Tensor, arr: Array, d: Design, *, clip, lo=None,
           hi=None, lower: bool = False):
    """``x @ W`` through the arrays, (..., N) float32.  With ``lo`` and
    ``hi`` None the ADC is bypassed (calibration) and the pre-ADC values
    (P, M, N) come back too."""
    lead = x.shape[:-1]
    x_int, s_x = quantize(x.reshape(-1, x.shape[-1]).float(), clip, d.q_x)
    v = pre_adc(x_int, arr, d, lower, by_line=lo is None)
    if lo is None:
        y = (v * d.gain).sum(0) * arr.w_scale * s_x
        return y.reshape(*lead, -1), v
    lsb = adc_lsb(lo, hi, d.adc_bits)
    acc = torch.zeros(v.shape[1:], dtype=torch.float32, device=v.device)
    if d.code_units:
        for vp in v:                                    # arrays ascending
            acc = acc + (lo / lsb + adc_code(vp, lo, lsb, d.adc_bits))
        y = acc * (d.gain * arr.w_scale * s_x * lsb)
    else:
        for vp in v:
            acc = acc + (lo + adc_code(vp, lo, lsb, d.adc_bits) * lsb) \
                * d.gain
        y = acc * arr.w_scale * s_x
    return y.reshape(*lead, -1)
