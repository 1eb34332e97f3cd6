"""The bounds a kernel is held to against its plain version (or the port
against the reference), and the case grids they are checked on, shared by
the tests and ``chip_smoke.py``.

Fused MVM (the bound of ``tests/test_kernels.py::_assert_close_codes``):
each output is within 2 float32 ulps, or within 0.25 of a dequant grid
step (``scale``), of the plain value — except that an element may differ
by exactly one ADC code of one term where the plain version's pre-ADC
value of that term lies within 4 ulps of a rounding edge.  Such flips are
counted; a difference explained by nothing else fails.  Sums are taken in
different orders on the two sides, so bitwise equality is not the
contract.

Flash decode: ``out = sum_t p_t v_t / sum_t p_t`` with ``0 <= p_t <= 1``
and a denominator of at least 1, so summing the terms in another order
moves each output by at most ``kv_len * eps * max_t |v_t|`` (the standard
bound on reordering a sum of ``kv_len`` terms), and the ``exp`` and the
division add a few ulps of the output: each element must lie within
``4 ulp(|out|) + kv_len * eps * max|v|`` of the plain value, with
``max|v|`` over the row's valid positions and its KV head.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.fused import adc_lsb
from repro_torch.kernels.ref import fused_pre_adc

F32_EPS = float(torch.finfo(torch.float32).eps)
FUSED_ULP = 2.0       # fused MVM: ulps of the output ...
FUSED_CODES = 0.25    # ... or this share of a dequant grid step
EDGE_ULP = 4.0        # a one-code flip needs a pre-ADC value this near an edge
FLASH_ULP = 4.0       # flash decode: ulps of the output, plus the sum's bound

#: fused-MVM cases (m, p, s, rows, n, n_bits, cell_bits): the single-slice
#: grid of ``tests/test_kernels.py`` in both input modes, then its
#: multi-slice cases
_SINGLE = [(1, 1, 64, 16), (2, 1, 33, 7), (8, 1, 256, 128), (8, 2, 96, 40),
           (4, 3, 72, 24)]
FUSED_GRID = ([(m, p, 1, r, n, nb, 7) for (m, p, r, n) in _SINGLE
               for nb in (None, 7)]
              + [(8, 1, 2, 40, 24, None, 2), (4, 2, 4, 33, 7, 7, 2),
                 (8, 1, 3, 96, 130, None, 2), (2, 1, 4, 64, 16, 7, 2)])
#: flash-decode cases (b, s, kv, g, hd): ragged fills, GQA groups
FLASH_GRID = [(1, 8, 2, 1, 8), (2, 16, 2, 2, 8), (3, 40, 2, 1, 32),
              (4, 33, 4, 2, 16), (2, 9, 1, 4, 8)]


def fused_case(m, p, s, rows, n, seed=None):
    """numpy operands of one fused-MVM case: integer activations,
    conductances in [0, 0.1), per-slice ADC ranges.  The seed defaults to
    one derived from the shape, so every caller draws the same case."""
    rng = np.random.default_rng(m * 11 + rows + s if seed is None else seed)
    x = np.round(rng.standard_normal((m, p, rows)) * 40).astype(np.float32)
    gp = (rng.random((s, p, rows, n)) * 0.1).astype(np.float32)
    gm = (rng.random((s, p, rows, n)) * 0.1).astype(np.float32)
    lo = np.linspace(-60.0, -40.0, s).astype(np.float32)
    hi = np.linspace(40.0, 60.0, s).astype(np.float32)
    return x, gp, gm, lo, hi


def flash_case(b, s, kv, g, hd, seed=None):
    """numpy operands of one flash-decode case: q (b, kv*g, hd), k and v
    (b, s, kv, hd), fills in [1, s].  The seed defaults to one derived from
    the shape."""
    rng = np.random.default_rng(b * 7 + s if seed is None else seed)
    q = rng.standard_normal((b, kv * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    fills = rng.integers(1, s + 1, size=b).astype(np.int32)
    return q, k, v, fills


def _spacing(mag: torch.Tensor) -> torch.Tensor:
    """float32 ulp of ``mag`` (>= 0), like ``np.spacing``."""
    mag = mag.to(torch.float32)
    return torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag


def fused_mvm_check(
    y: torch.Tensor,          # (M, N) result under test
    y_plain: torch.Tensor,    # (M, N) plain (or reference) result
    x_parts: torch.Tensor,    # the operands both were computed from
    g_pos: torch.Tensor,
    g_neg: torch.Tensor,
    adc_lo,
    adc_hi,
    scale,
    *,
    adc_bits: int,
    cell_bits: int,
    n_bits: Optional[int],
) -> Dict[str, float]:
    """Hold ``y`` against ``y_plain`` under the fused-MVM bound.  Returns
    ``ok``, ``flips`` (allowed one-code flips), ``bad`` (elements outside
    the bound), ``max_abs_err`` and ``max_ulp``."""
    dev = y_plain.device
    y = y.to(device=dev, dtype=torch.float32)
    y_plain = y_plain.to(torch.float32)
    scale = float(torch.as_tensor(scale).reshape(()))
    d = (y - y_plain).abs()
    mag = torch.maximum(y.abs(), y_plain.abs())
    ulps = _spacing(mag)
    tight = (d <= FUSED_ULP * ulps) | (d <= FUSED_CODES * scale)
    explained = tight.clone()
    p = x_parts.shape[1]
    n_slices = g_pos.shape[0]
    lo = torch.as_tensor(adc_lo, device=dev).to(torch.float32).reshape(n_slices)
    hi = torch.as_tensor(adc_hi, device=dev).to(torch.float32).reshape(n_slices)
    if not bool(tight.all()):
        # the plain version's pre-ADC value of every term, (P, S, B, M, N)
        v_all = fused_pre_adc(x_parts.to(dev), g_pos.to(dev), g_neg.to(dev),
                              n_bits)
        bits = (None,) if n_bits is None else tuple(range(n_bits))
        for pi in range(p):
            for s in range(n_slices):
                lsb = adc_lsb(lo[s], hi[s], adc_bits)
                for bi, b in enumerate(bits):
                    v = v_all[pi, s, bi]
                    t = ((v - lo[s]) / lsb).to(torch.float64)
                    edge = lo[s].double() + (torch.floor(t) + 0.5) * lsb.double()
                    near = (v.double() - edge).abs() <= EDGE_ULP * _spacing(
                        v.abs()).double()
                    w = 2.0 ** ((0 if b is None else b) + cell_bits * s)
                    step = scale * float(lsb) * w
                    one_code = ((d - step).abs()
                                <= FUSED_ULP * ulps + FUSED_CODES * scale)
                    explained |= near & one_code
    bad = ~explained
    rel = torch.where(d > 0, d / ulps, torch.zeros_like(d))
    return {
        "ok": not bool(bad.any()),
        "flips": int((explained & ~tight).sum()),
        "bad": int(bad.sum()),
        "max_abs_err": float(d.max()) if d.numel() else 0.0,
        "max_ulp": float(rel.max()) if d.numel() else 0.0,
    }


def flash_decode_check(
    out: torch.Tensor,        # (B, H, hd) result under test
    out_plain: torch.Tensor,  # (B, H, hd)
    v: torch.Tensor,          # (B, S, KV, hd) the values both attended over
    kv_len: torch.Tensor,     # (B,)
) -> Dict[str, float]:
    """Hold ``out`` against ``out_plain`` under the flash-decode bound;
    returns ``ok``, ``bad``, ``max_abs_err`` and the largest error in
    units of the element's bound (``max_bound_frac``)."""
    dev = out_plain.device
    out = out.to(device=dev, dtype=torch.float32)
    out_plain = out_plain.to(torch.float32)
    b, h, hd = out_plain.shape
    _, seq, kv_heads, _ = v.shape
    g = h // kv_heads
    lens = kv_len.to(device=dev, dtype=torch.int64).reshape(b)
    valid = torch.arange(seq, device=dev)[None, :] < lens[:, None]
    vabs = v.to(device=dev, dtype=torch.float32).abs().amax(dim=-1)  # (B,S,KV)
    vmax = torch.where(valid[:, :, None], vabs, torch.zeros_like(vabs)) \
        .amax(dim=1)                                                  # (B,KV)
    vmax = vmax.repeat_interleave(g, dim=1)[:, :, None]               # (B,H,1)
    d = (out - out_plain).abs()
    mag = torch.maximum(out.abs(), out_plain.abs())
    bound = FLASH_ULP * _spacing(mag) + lens[:, None, None].float() * F32_EPS * vmax
    frac = d / bound
    return {
        "ok": bool((d <= bound).all()),
        "bad": int((d > bound).sum()),
        "max_abs_err": float(d.max()) if d.numel() else 0.0,
        "max_bound_frac": float(frac.max()) if d.numel() else 0.0,
    }
