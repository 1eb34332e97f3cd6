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

The other ADC'd kernels are held to the same bound.  Fused parasitic MVM:
its terms are the per-(partition, slice) analog bit folds of the Thomas
currents, the grid step is ``scale``.  The legacy Design-A kernels (with
and without parasitics) return code units ``sum_p (lo + code * lsb) *
gain``: within 2 ulp or 0.25 of ``gain``, and a one-code flip moves an
output by ``gain * lsb``.

Bit-line currents (the Thomas sweep alone): within 2 ulps of ``|I|``.  The
kernel, its plain version and the reference take the same rounded
operations in the same order, so they are expected to agree to the bit.

Flash decode: ``out = sum_t p_t v_t / sum_t p_t`` with ``0 <= p_t <= 1``
and a denominator of at least 1, so summing the terms in another order
moves each output by at most ``kv_len * eps * max_t |v_t|`` (the standard
bound on reordering a sum of ``kv_len`` terms), and the ``exp`` and the
division add a few ulps of the output: each element must lie within
``4 ulp(|out|) + kv_len * eps * max|v|`` of the plain value, with
``max|v|`` over the row's valid positions and its KV head.

Paged attention: the flash-decode bound, ``v`` being the gathered view
``v_pages[ptab]`` of each row's pages.  The paged kernel and the
flash-decode kernel sum in one order that depends on ``kv_len`` alone, so
on a pool and the dense view gathered from it they agree to the bit.

At tens of thousands of positions that bound is loose: ``kv_len * eps *
max|v|`` exceeds a typical output, so a kernel that dropped a chunk of
positions would pass it.  Beside it, a decode-attention result of a row of
``n >= 1`` valid positions is also held against the same function
evaluated in float64 on the same inputs, under a bound built from the
output's own terms, ``A = sum_t p_t |v_t| / sum_t p_t``.  Treating the
float32 rounding errors as independent, a sum of ``n`` terms errs by about
``sqrt(n) * u`` of the sum of their magnitudes (the statistical estimate
of Higham's *Accuracy and Stability of Numerical Algorithms*, sec. 2.8),
so a logit of ``hd`` products errs by at most ``delta = 4 * eps * (sqrt(hd)
* M + 1)``, ``M = max_t sum_d |scale * q_d * k_td|`` (its dot, the
scaling, the subtraction of the max, and ``exp``), which moves the output
by at most ``2 * delta * A``; the sums of ``p_t v_t`` and of ``p_t``, and
the products, add ``8 * sqrt(n) * eps * A``.  Each element must lie within
``4 ulp(|out|) + (2 * delta + 8 * sqrt(n) * eps) * A`` of the float64
value.  Dropping one chunk of 256 of 32768 positions moves an output by
about ``sqrt(e / 256) / 128``, several times that bound.

A row with ``kv_len`` 0 has no valid position: every logit is the mask
value, so the plain version (as the reference) averages ``v`` over the
whole capacity.  Its bound is the flash-decode bound with the capacity in
place of ``kv_len``.

Design-D bit-serial MVM: the legacy bound (within 2 ulp or 0.25 of
``gain``), its ADC'd terms being each (partition, bit)'s dot, a one-code
flip of bit ``b`` moving the output by ``gain * lsb * 2**b``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.quant import true_div
from repro_torch.kernels.fused import adc_lsb
from repro_torch.kernels.ref import fused_pre_adc, parasitic_pre_adc

F32_EPS = float(torch.finfo(torch.float32).eps)
FUSED_ULP = 2.0       # fused MVM: ulps of the output ...
FUSED_CODES = 0.25    # ... or this share of a dequant grid step
EDGE_ULP = 4.0        # a one-code flip needs a pre-ADC value this near an edge
FLASH_ULP = 4.0       # flash decode: ulps of the output, plus the sum's bound
BITLINE_ULP = 2.0     # bit-line currents: ulps of |I|

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
#: bit-line cases (m, k, n, r_hat) of ``tests/test_kernels.py``: the solver
#: grid (minimal chains, one column, a full 1152-row line, heavy sag, ragged
#: M and N), then the dense-solve grid
BITLINE_GRID = [(8, 17, 16, 1e-3), (32, 96, 24, 1e-4), (16, 200, 8, 1e-5),
                (128, 64, 128, 3e-4), (4, 2, 3, 1e-3), (8, 33, 1, 5e-4),
                (4, 1152, 4, 1e-4), (16, 72, 8, 5e-3), (3, 13, 130, 1e-4),
                (130, 7, 5, 1e-3), (9, 129, 127, 1e-4)]
BITLINE_DENSE_GRID = [(4, 23, 6, 2e-3), (3, 13, 9, 1e-3), (5, 130, 2, 1e-4)]
#: legacy parasitic Design-A cases (m, p, rows, n), at r_hat 1e-3
LEGACY_PARASITIC_GRID = [(8, 1, 16, 8), (16, 2, 33, 7), (8, 2, 8, 130),
                         (130, 1, 72, 24)]
#: legacy Design-A cases (m, p, rows, n, adc_bits): the shape grid at 6 and
#: 8 ADC bits, then the edge shapes at 8
_MVM = [(8, 1, 64, 16), (32, 2, 96, 40), (128, 1, 1152, 256),
        (64, 3, 200, 24), (16, 2, 8, 8)]
_MVM_EDGE = [(4, 1, 1, 8), (8, 2, 33, 7), (16, 1, 129, 130), (8, 4, 72, 3),
             (1, 1, 64, 16), (2, 3, 40, 24)]
LEGACY_GRID = ([c + (b,) for c in _MVM for b in (6, 8)]
               + [c + (8,) for c in _MVM_EDGE])
#: fused parasitic cases (m, p, s, rows, n, r_hat): single- and two-slice,
#: a small-M decode row, each at two parasitic levels
FUSED_PARASITIC_GRID = [c + (r,) for c in ((4, 1, 1, 24, 9), (8, 2, 2, 33, 7),
                                           (2, 1, 1, 64, 16))
                        for r in (1e-5, 1e-3)]
LEGACY_GAIN = 127.0
LEGACY_RANGE = (-50.0, 50.0)
#: paged-attention cases (b, h, kv, hd, page_size, NP, pool dtype): the
#: ``PAGED_SHAPES`` of ``tests/test_kernels.py`` (multi-page rows, ragged
#: last pages, GQA groups, single-page tables, page_size 1) with float32
#: pools, then a bfloat16 pool at qwen1.5-4b's KV heads and head dimension
PAGED_GRID = [c + ("float32",) for c in (
    (1, 2, 1, 8, 4, 2), (3, 4, 2, 8, 4, 4), (2, 4, 4, 16, 8, 2),
    (4, 8, 2, 32, 8, 4), (2, 2, 2, 8, 4, 1), (3, 2, 1, 8, 1, 6),
    (2, 6, 3, 8, 2, 5))] + [(4, 20, 20, 128, 8, 4, "bfloat16")]
#: card-only decode-attention cases (s, kv, g, hd, dtype, page_size) at the
#: edges of the kernel's split of positions (``csrc/flash_decode.cu``: chunks
#: of ``ATTN_CHUNK`` positions, up to 8 CTAs a cluster): lengths 2048, 5000
#: and 32768, g 1/4/8, hd 64/128/256, float32 and bfloat16 caches, pools of
#: pages of 1, 16 and 64 positions (a table past the kernel's 1024
#: shared-memory entries at 32768 x page 1, logits past its shared memory at
#: 32768 x g 8), then rows of 24 bytes (hd 12, bf16), which the kernel
#: copies with plain loads; each case's rows take the fills of
#: :func:`attn_edge_fills`
ATTN_EDGE_GRID = [(2048, 2, 1, 128, "bfloat16", 16),
                  (2048, 2, 4, 64, "float32", 1),
                  (2048, 1, 8, 256, "bfloat16", 64),
                  (5000, 2, 1, 128, "float32", 64),
                  (5000, 1, 4, 256, "bfloat16", 1),
                  (5000, 2, 8, 64, "bfloat16", 16),
                  (32768, 2, 1, 128, "bfloat16", 16),
                  (32768, 1, 8, 256, "float32", 1),
                  (32768, 1, 4, 64, "bfloat16", 64),
                  (600, 2, 2, 12, "bfloat16", 4)]
ATTN_CHUNK = 256      # positions per ordered chunk sum in the kernel
ATTN_CLUSTER = 8      # most CTAs per (row, KV head)
#: Design-D bit-serial cases (m, p, rows, n, n_bits): the first four legacy
#: shapes and the edge shapes, at 4 and 7 input bits
#: (``tests/test_kernels.py::test_analog_mvm_bitserial_matches_ref``)
BITSERIAL_GRID = [c + (nb,) for c in _MVM[:4] + _MVM_EDGE for nb in (4, 7)]
BITSERIAL_GAIN = 127.0
BITSERIAL_RANGE = (-20.0, 20.0)


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


def paged_case(b, h, kv, hd, ps, n_pages, seed=0):
    """numpy operands of one paged-attention case: q (b, h, hd), a pool of
    ``1 + b * n_pages`` pages (ps, kv, hd) for K and for V, a block table
    (b, n_pages) of shuffled pages with ragged fills (the last page partly
    valid) and sink-padded tails, and the fills (b,)."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + b * n_pages
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k_pages = rng.standard_normal((num_pages, ps, kv, hd)).astype(np.float32)
    v_pages = rng.standard_normal((num_pages, ps, kv, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))
    ptab = np.zeros((b, n_pages), np.int32)
    kv_len = np.zeros((b,), np.int32)
    for i in range(b):
        n = int(rng.integers(1, n_pages * ps + 1))
        used = -(-n // ps)
        ptab[i, :used] = perm[i * n_pages:i * n_pages + used]
        kv_len[i] = n
    return q, k_pages, v_pages, ptab, kv_len


def attn_edge_fills(s: int):
    """Fills at the edges of the kernel's split of a capacity ``s``: 1, a
    chunk - 1, a chunk, a chunk + 1, one CTA's span +- 1 and the full
    capacity, deduplicated, ascending."""
    n_ch = -(-s // ATTN_CHUNK)
    c = min(ATTN_CLUSTER, n_ch)
    span = -(-n_ch // c) * ATTN_CHUNK
    fills = {1, ATTN_CHUNK - 1, ATTN_CHUNK, ATTN_CHUNK + 1, span - 1,
             span + 1, s}
    return sorted(f for f in fills if 1 <= f <= s)


def attn_edge_case(s, kv, g, hd, dtype, ps, device, seed=0):
    """One :data:`ATTN_EDGE_GRID` case, drawn on ``device`` from a seeded
    generator: q (b, kv*g, hd) float32, a dense cache k, v (b, s, kv, hd)
    in ``dtype``, the fills (b,) of :func:`attn_edge_fills`, and the same
    cache as a pool: pages of ``ps`` positions (the last page's tail
    random), shuffled, behind a sink page 0, with its (b, NP) table."""
    fills = attn_edge_fills(s)
    b = len(fills)
    n_pages = -(-s // ps)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q = normal(b, kv * g, hd)
    k = normal(b, n_pages * ps, kv, hd).to(dt)
    v = normal(b, n_pages * ps, kv, hd).to(dt)
    perm = 1 + torch.randperm(b * n_pages, generator=gen, device=device)
    ptab = perm.reshape(b, n_pages).to(torch.int32)
    k_pages = torch.empty((1 + b * n_pages, ps, kv, hd), dtype=dt,
                          device=device)
    v_pages = torch.empty_like(k_pages)
    k_pages[0], v_pages[0] = normal(ps, kv, hd).to(dt), normal(ps, kv, hd).to(dt)
    k_pages[ptab.long()] = k.reshape(b, n_pages, ps, kv, hd)
    v_pages[ptab.long()] = v.reshape(b, n_pages, ps, kv, hd)
    lens = torch.tensor(fills, dtype=torch.int32, device=device)
    return (q, k[:, :s].contiguous(), v[:, :s].contiguous(), lens, k_pages,
            v_pages, ptab)


def bitserial_case(m, p, rows, n, n_bits, seed=None):
    """numpy operands of one bit-serial case: signed integer activations of
    at most ``n_bits`` magnitude bits (m, p, rows), conductances (p, rows,
    n) in [0, 0.1)."""
    rng = np.random.default_rng(m + p + n_bits + rows if seed is None
                                else seed)
    qmax = 2 ** n_bits - 1
    x = np.clip(np.round(rng.standard_normal((m, p, rows)) * qmax / 3),
                -qmax, qmax).astype(np.float32)
    gp = (rng.random((p, rows, n)) * 0.1).astype(np.float32)
    gm = (rng.random((p, rows, n)) * 0.1).astype(np.float32)
    return x, gp, gm


def fused_parasitic_case(m, p, s, rows, n):
    """numpy operands of one fused parasitic case: :func:`fused_case` with
    the activations clipped to 8-bit signed."""
    x, gp, gm, lo, hi = fused_case(m, p, s, rows, n, seed=rows + n)
    return np.clip(x, -127, 127), gp, gm, lo, hi


def bitline_case(m, k, n, seed=None):
    """numpy operands of one bit-line case: a signed plane (m, k) in
    {-1, 0, +1} with about 40% zeros, conductances (k, n) in [0, 1)."""
    rng = np.random.default_rng(k if seed is None else seed)
    x = (np.sign(rng.standard_normal((m, k)))
         * (rng.random((m, k)) > 0.4)).astype(np.float32)
    g = rng.random((k, n)).astype(np.float32)
    return x, g


def legacy_case(m, p, rows, n, seed=None):
    """numpy operands of one legacy Design-A case: 8-bit signed integer
    activations (m, p, rows), conductances (p, rows, n) in [0, 0.1)."""
    rng = np.random.default_rng(m * 3 + rows if seed is None else seed)
    x = np.clip(np.round(rng.standard_normal((m, p, rows)) * 40),
                -127, 127).astype(np.float32)
    gp = (rng.random((p, rows, n)) * 0.1).astype(np.float32)
    gm = (rng.random((p, rows, n)) * 0.1).astype(np.float32)
    return x, gp, gm


def _spacing(mag: torch.Tensor) -> torch.Tensor:
    """float32 ulp of ``mag`` (>= 0), like ``np.spacing``."""
    mag = mag.to(torch.float32)
    return torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag


def _codes_check(y, y_plain, tol_abs: float, terms) -> Dict[str, float]:
    """Hold ``y`` against ``y_plain``: each element within ``FUSED_ULP``
    ulps or ``tol_abs``, or off by exactly one ADC code of one term whose
    plain pre-ADC value lies within ``EDGE_ULP`` ulps of a rounding edge
    (or on the other side of it from the other side's own pre-ADC value,
    where that is given).  ``terms()`` yields ``(v, lo, lsb, step, v_other)``
    per ADC'd term: its plain pre-ADC values, range start and step, how far
    one code moves the output, and the other side's pre-ADC values or
    None; it is called only if some element is not tight."""
    dev = y_plain.device
    y = y.to(device=dev, dtype=torch.float32)
    y_plain = y_plain.to(torch.float32)
    d = (y - y_plain).abs()
    mag = torch.maximum(y.abs(), y_plain.abs())
    ulps = _spacing(mag)
    tight = (d <= FUSED_ULP * ulps) | (d <= tol_abs)
    explained = tight.clone()
    if not bool(tight.all()):
        for v, lo, lsb, step, v_other in terms():
            t = ((v - lo) / lsb).to(torch.float64)
            edge = lo.double() + (torch.floor(t) + 0.5) * lsb.double()
            near = (v.double() - edge).abs() <= EDGE_ULP * _spacing(
                v.abs()).double()
            if v_other is not None:
                lo_edge = edge - lsb.double()
                vo = v_other.to(device=dev, dtype=torch.float64)
                near |= (vo >= edge) | (vo <= lo_edge)
            one_code = (d - step).abs() <= FUSED_ULP * ulps + tol_abs
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


def _slice_ranges(adc_lo, adc_hi, n_slices: int, dev):
    lo = torch.as_tensor(adc_lo, device=dev).to(torch.float32).reshape(n_slices)
    hi = torch.as_tensor(adc_hi, device=dev).to(torch.float32).reshape(n_slices)
    return lo, hi


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
    scale = float(torch.as_tensor(scale).reshape(()))
    n_slices = g_pos.shape[0]
    lo, hi = _slice_ranges(adc_lo, adc_hi, n_slices, dev)

    def terms():
        # the plain version's pre-ADC value of every term, (P, S, B, M, N)
        v_all = fused_pre_adc(x_parts.to(dev), g_pos.to(dev), g_neg.to(dev),
                              n_bits)
        bits = (None,) if n_bits is None else tuple(range(n_bits))
        for pi in range(x_parts.shape[1]):
            for s in range(n_slices):
                lsb = adc_lsb(lo[s], hi[s], adc_bits)
                for bi, b in enumerate(bits):
                    w = 2.0 ** ((0 if b is None else b) + cell_bits * s)
                    yield (v_all[pi, s, bi], lo[s], lsb,
                           scale * float(lsb) * w, None)

    return _codes_check(y, y_plain, FUSED_CODES * scale, terms)


def fused_mvm_parasitic_check(
    y: torch.Tensor,          # (M, N) result under test
    y_plain: torch.Tensor,    # (M, N) plain (or reference) result
    x_parts: torch.Tensor,    # the operands both were computed from
    g_pos: torch.Tensor,
    g_neg: torch.Tensor,
    r_hat,
    adc_lo,
    adc_hi,
    scale,
    *,
    adc_bits: int,
    cell_bits: int,
    n_bits: int,
) -> Dict[str, float]:
    """Hold ``y`` against ``y_plain`` under the fused bound, the terms being
    the per-(partition, slice) analog bit folds of the parasitic chain."""
    dev = y_plain.device
    scale = float(torch.as_tensor(scale).reshape(()))
    n_slices = g_pos.shape[0]
    lo, hi = _slice_ranges(adc_lo, adc_hi, n_slices, dev)

    def terms():
        v_all = parasitic_pre_adc(x_parts.to(dev), g_pos.to(dev),
                                  g_neg.to(dev), r_hat, n_bits)
        for pi in range(x_parts.shape[1]):
            for s in range(n_slices):
                lsb = adc_lsb(lo[s], hi[s], adc_bits)
                w = 2.0 ** (cell_bits * s)
                yield v_all[pi, s], lo[s], lsb, scale * float(lsb) * w, None

    return _codes_check(y, y_plain, FUSED_CODES * scale, terms)


def analog_mvm_check(
    y: torch.Tensor,          # (M, N) code units under test
    y_plain: torch.Tensor,    # (M, N) plain (or reference) result
    x_parts: torch.Tensor,    # (M, P, rows) the operands
    g_pos: torch.Tensor,      # (P, rows, N)
    g_neg: torch.Tensor,
    adc_lo,
    adc_hi,
    gain: float,
    *,
    adc_bits: int,
    r_hat=None,               # parasitic level (legacy parasitic kernel)
    n_bits: Optional[int] = None,
    v_other: Optional[torch.Tensor] = None,
) -> Dict[str, float]:
    """Hold a legacy Design-A result (``r_hat`` None) or a legacy parasitic
    one against ``y_plain``: within 2 ulp or 0.25 of ``gain``, one-code
    flips (``gain * lsb``) only next to a rounding edge of a partition's
    pre-ADC value.  ``v_other`` (P, M, N), the pre-ADC values on the side
    of ``y`` where they were summed in another order, also explains a flip
    where they lie across the edge from the plain value."""
    dev = y_plain.device
    lo, hi = _slice_ranges(adc_lo, adc_hi, 1, dev)
    lsb = true_div(hi[0] - lo[0], 2 ** adc_bits - 1)

    def terms():
        x, gp, gm = x_parts.to(dev), g_pos.to(dev)[None], g_neg.to(dev)[None]
        if r_hat is None:
            v_all = fused_pre_adc(x, gp, gm, None)[:, 0, 0]
        else:
            v_all = parasitic_pre_adc(x, gp, gm, r_hat, n_bits)[:, 0]
        for pi, v in enumerate(v_all):
            yield (v, lo[0], lsb, float(gain) * float(lsb),
                   None if v_other is None else v_other[pi])

    return _codes_check(y, y_plain, FUSED_CODES * float(gain), terms)


def bitserial_check(
    y: torch.Tensor,          # (M, N) code units under test
    y_plain: torch.Tensor,    # (M, N) plain (or reference) result
    x_parts: torch.Tensor,    # (M, P, rows) the operands
    g_pos: torch.Tensor,      # (P, rows, N)
    g_neg: torch.Tensor,
    adc_lo,
    adc_hi,
    gain: float,
    *,
    adc_bits: int,
    n_bits: int,
    v_other: Optional[torch.Tensor] = None,
) -> Dict[str, float]:
    """Hold a Design-D bit-serial result against ``y_plain``: within 2 ulp
    or 0.25 of ``gain``, a one-code flip of bit ``b`` (``gain * lsb *
    2**b``) only next to a rounding edge of that (partition, bit)'s pre-ADC
    value.  ``v_other`` (P, B, M, N), the pre-ADC values on the side of
    ``y`` where they were summed in another order, also explains a flip
    where they lie across the edge from the plain value."""
    dev = y_plain.device
    lo, hi = _slice_ranges(adc_lo, adc_hi, 1, dev)
    lsb = true_div(hi[0] - lo[0], 2 ** adc_bits - 1)

    def terms():
        v_all = fused_pre_adc(x_parts.to(dev), g_pos.to(dev)[None],
                              g_neg.to(dev)[None], n_bits)[:, 0]
        for pi in range(v_all.shape[0]):
            for b in range(n_bits):
                yield (v_all[pi, b], lo[0], lsb,
                       float(gain) * float(lsb) * 2.0 ** b,
                       None if v_other is None else v_other[pi, b])

    return _codes_check(y, y_plain, FUSED_CODES * float(gain), terms)


def bitline_check(i: torch.Tensor, i_plain: torch.Tensor) -> Dict[str, float]:
    """Hold bit-line currents within ``BITLINE_ULP`` ulps of ``|I|``;
    returns ``ok``, ``bad``, ``max_abs_err`` and ``max_ulp``."""
    dev = i_plain.device
    i = i.to(device=dev, dtype=torch.float32)
    i_plain = i_plain.to(torch.float32)
    d = (i - i_plain).abs()
    ulps = _spacing(torch.maximum(i.abs(), i_plain.abs()))
    bad = d > BITLINE_ULP * ulps
    rel = torch.where(d > 0, d / ulps, torch.zeros_like(d))
    return {
        "ok": not bool(bad.any()),
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


def attention_f64_check(
    out: torch.Tensor,        # (B, H, hd) result under test
    q: torch.Tensor,          # (B, H, hd) the operands it was computed from
    k: torch.Tensor,          # (B, S, KV, hd)
    v: torch.Tensor,          # (B, S, KV, hd)
    kv_len: torch.Tensor,     # (B,) each in [1, S]
) -> Dict[str, float]:
    """Hold a decode-attention result against the same function in float64
    (scores scaled by ``hd ** -0.5`` rounded to float32, as the kernels
    take it) under the bound of the module docstring, built from each
    output's own terms; returns ``ok``, ``bad``, ``max_abs_err`` and
    ``max_bound_frac``.  Row by row, so a long cache is widened one row at
    a time."""
    dev = out.device
    b, h, hd = q.shape
    kv_heads = k.shape[2]
    g = h // kv_heads
    scale = float(np.float32(hd ** -0.5))
    bad, max_err, max_frac = 0, 0.0, 0.0
    for i in range(b):
        n = int(kv_len[i])
        if not 1 <= n <= k.shape[1]:
            raise ValueError(f"row {i}: kv_len {n} outside [1, {k.shape[1]}]")
        qs = q[i].to(dev, torch.float64).reshape(kv_heads, g, hd) * scale
        ki = k[i, :n].to(dev, torch.float64)
        vi = v[i, :n].to(dev, torch.float64)
        s = torch.einsum("kgd,tkd->kgt", qs, ki)
        mag = torch.einsum("kgd,tkd->kgt", qs.abs(), ki.abs()).amax(-1)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        den = p.sum(-1)[..., None]
        ref = torch.einsum("kgt,tkd->kgd", p, vi) / den
        terms = torch.einsum("kgt,tkd->kgd", p, vi.abs()) / den
        delta = 4 * F32_EPS * (hd ** 0.5 * mag + 1)
        bound = (FLASH_ULP * _spacing(ref.abs()).double()
                 + (2 * delta[..., None] + 8 * n ** 0.5 * F32_EPS) * terms)
        d = (out[i].to(dev, torch.float64).reshape(kv_heads, g, hd)
             - ref).abs()
        bad += int((d > bound).sum())
        max_err = max(max_err, float(d.max()))
        max_frac = max(max_frac, float((d / bound).max()))
    return {"ok": bad == 0, "bad": bad, "max_abs_err": max_err,
            "max_bound_frac": max_frac}


def paged_attention_check(
    out: torch.Tensor,        # (B, H, hd) result under test
    out_plain: torch.Tensor,  # (B, H, hd)
    v_pages: torch.Tensor,    # (P, ps, KV, hd) the pool both attended over
    ptab: torch.Tensor,       # (B, NP) block table
    kv_len: torch.Tensor,     # (B,)
) -> Dict[str, float]:
    """Hold ``out`` against ``out_plain`` under the flash-decode bound, over
    the gathered view of each row's pages."""
    dev = out_plain.device
    b, n_pages = ptab.shape
    _, ps, kv_heads, hd = v_pages.shape
    v = v_pages.to(dev)[ptab.to(dev).long()].reshape(b, n_pages * ps,
                                                     kv_heads, hd)
    return flash_decode_check(out, out_plain, v, kv_len)
