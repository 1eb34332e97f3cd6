"""Plain PyTorch versions of the serving kernels (counterpart of
``repro.kernels.ref``).

They are what the wrappers in ``kernels.ops`` run for CPU tensors, and
what ``chip_smoke.py`` and the card-marked tests hold each CUDA kernel
against on the card.  They mirror the reference oracles' float32
arithmetic.  Like the reference's fused oracle, which walks its kernel's
tile order, the MVM dots (fused and legacy) are taken in their CUDA
kernels' order: each output summed over the array rows in ascending order,
one float32 multiply and one float32 add per row.  That makes a kernel and
its plain version agree to the bit, and makes both independent of how many
rows share a call (a BLAS matmul picks its summation order by shape).

The parasitic versions sweep each bit line with the reference's Thomas
recurrence (:func:`_thomas_bottom_current`, ``core.parasitics``), every
product feeding an add exact and every division IEEE, and fold bits,
slices and partitions in the kernels' fixed order (bits ascending,
``accb + (i_pos - i_neg) * 2**b``; partitions ascending from zero).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.parasitics import bitline_currents
from repro_torch.core.parasitics import bottom_current as _thomas_bottom_current
from repro_torch.kernels.analog_mvm import _adc_epilogue
from repro_torch.kernels.fused import (_bit_plane, adc_lsb,
                                       fused_adc_code_units, term_weight)

NEG_INF = -1e30                      # models.layers.NEG_INF
FLASH_BLOCK = 8                      # the reference oracle's page length


def fused_pre_adc(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued
    g_pos: torch.Tensor,     # (S, P, rows, N)
    g_neg: torch.Tensor,     # (S, P, rows, N)
    n_bits: Optional[int],   # None = analog input accumulation
) -> torch.Tensor:
    """Pre-ADC values of every term, (P, S, B, M, N) float32 with B = 1 for
    analog accumulation else ``n_bits``: the dot of each input (or signed
    bit plane) with ``g = g_pos - g_neg``, summed over rows in ascending
    order with a rounded multiply and a rounded add per row."""
    m, p, rows = x_parts.shape
    n_slices, _, _, n = g_pos.shape
    x = x_parts.to(torch.float32).permute(1, 0, 2)                # (P, M, rows)
    if n_bits is None:
        planes = x[:, None]
    else:
        sign, mag = torch.sign(x), x.abs()
        planes = torch.stack([_bit_plane(mag, sign, b)
                              for b in range(n_bits)], dim=1)    # (P, B, M, rows)
    g = (g_pos.to(torch.float32) - g_neg.to(torch.float32)).permute(1, 0, 2, 3)
    v = torch.zeros((p, n_slices, planes.shape[1], m, n), dtype=torch.float32,
                    device=x_parts.device)
    for r in range(rows):
        v = v + planes[:, None, :, :, r, None] * g[:, :, None, None, r, :]
    return v


def fused_mvm_diff(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued
    g_pos: torch.Tensor,     # (S, P, rows, N)
    g_neg: torch.Tensor,     # (S, P, rows, N)
    adc_lo,                  # (S,) per-slice calibrated range
    adc_hi,
    scale,                   # scalar: gain * w_scale * x_scale
    *,
    adc_bits: int,
    cell_bits: int,
    n_bits: Optional[int],   # None = analog input accumulation
) -> torch.Tensor:
    """Plain version of the fused differential MVM chain: per partition,
    slice and input bit, the dot with ``g_pos - g_neg``, the code-unit ADC,
    shift-and-add; partitions summed in order; one final dequant multiply
    — the reference oracle's order of operations, without its TPU tiles."""
    m, p, _ = x_parts.shape
    n_slices, _, _, n = g_pos.shape
    dev = x_parts.device
    scale = torch.as_tensor(scale, device=dev).to(torch.float32).reshape(())
    lo = torch.as_tensor(adc_lo, device=dev).to(torch.float32).reshape(n_slices)
    hi = torch.as_tensor(adc_hi, device=dev).to(torch.float32).reshape(n_slices)
    bits = (None,) if n_bits is None else tuple(range(n_bits))
    out_scale = scale
    if n_slices == 1:
        out_scale = scale * adc_lsb(lo[0], hi[0], adc_bits)

    v = fused_pre_adc(x_parts, g_pos, g_neg, n_bits)
    tot = torch.zeros((m, n), dtype=torch.float32, device=dev)
    for pi in range(p):
        acc = torch.zeros((m, n), dtype=torch.float32, device=dev)
        for s in range(n_slices):
            lsb = adc_lsb(lo[s], hi[s], adc_bits)
            a_s = torch.zeros((m, n), dtype=torch.float32, device=dev)
            for bi, b in enumerate(bits):
                q = fused_adc_code_units(v[pi, s, bi], lo[s], lsb, adc_bits)
                a_s = a_s + q * term_weight(0, 0, b)
            if n_slices == 1:
                acc = a_s
            else:
                acc = acc + (a_s * lsb) * term_weight(cell_bits, s, None)
        tot = tot + acc
    return tot * out_scale


def _scalars(dev, *vals, n: int = 1):
    """Each of ``vals`` as a float32 tensor of ``n`` elements on ``dev``
    (0-d when ``n == 1``), so no division ever takes a CPU scalar."""
    shape = () if n == 1 else (n,)
    return [torch.as_tensor(v, device=dev).to(torch.float32).reshape(shape)
            for v in vals]


def parasitic_pre_adc(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued
    g_pos: torch.Tensor,     # (S, P, rows, N)
    g_neg: torch.Tensor,     # (S, P, rows, N)
    r_hat,
    n_bits: int,
) -> torch.Tensor:
    """Pre-ADC values of the parasitic chain, (P, S, M, N) float32: for each
    partition and slice the analog bit fold ``sum_b (I_pos,b - I_neg,b) *
    2**b`` (bits ascending, from zero) of the Thomas bottom currents of the
    signed bit planes of ``x_parts``."""
    m, p, rows = x_parts.shape
    x = x_parts.to(torch.float32).permute(1, 0, 2)          # (P, M, rows)
    sign, mag = torch.sign(x), x.abs()
    acc = None
    for b in range(n_bits):
        plane = _bit_plane(mag, sign, b)[None]              # (1, P, M, rows)
        i_pos = _thomas_bottom_current(plane, g_pos, r_hat)  # (S, P, M, N)
        i_neg = _thomas_bottom_current(plane, g_neg, r_hat)
        term = (i_pos - i_neg) * 2.0 ** b
        acc = term if acc is None else acc + term                  # 0 + t == t
    return acc.permute(1, 0, 2, 3)


def fused_mvm_parasitic(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued
    g_pos: torch.Tensor,     # (S, P, rows, N)
    g_neg: torch.Tensor,     # (S, P, rows, N)
    r_hat,
    adc_lo,                  # (S,)
    adc_hi,
    scale,                   # scalar: gain * w_scale * x_scale
    *,
    adc_bits: int,
    cell_bits: int,
    n_bits: int,
) -> torch.Tensor:
    """Plain version of the fused parasitic chain: per partition and slice
    the analog bit fold of the Thomas currents of both lines, the code-unit
    ADC, the slice shift-and-add; partitions summed in order; one final
    dequant multiply (the reference oracle's order, without its tiles)."""
    m, p, _ = x_parts.shape
    n_slices, _, _, n = g_pos.shape
    dev = x_parts.device
    (scale,) = _scalars(dev, scale)
    lo, hi = _scalars(dev, adc_lo, adc_hi, n=n_slices)
    lo, hi = lo.reshape(n_slices), hi.reshape(n_slices)
    out_scale = scale
    if n_slices == 1:
        out_scale = scale * adc_lsb(lo[0], hi[0], adc_bits)
    v = parasitic_pre_adc(x_parts, g_pos, g_neg, r_hat, n_bits)  # (P,S,M,N)
    tot = torch.zeros((m, n), dtype=torch.float32, device=dev)
    for pi in range(p):
        acc = torch.zeros((m, n), dtype=torch.float32, device=dev)
        for s in range(n_slices):
            lsb = adc_lsb(lo[s], hi[s], adc_bits)
            a_s = fused_adc_code_units(v[pi, s], lo[s], lsb, adc_bits)
            if n_slices == 1:
                acc = a_s
            else:
                acc = acc + (a_s * lsb) * term_weight(cell_bits, s, None)
        tot = tot + acc
    return tot * out_scale


def bitline_mvm(
    g: torch.Tensor,         # (K, N), or (G, K, N) arrays
    x: torch.Tensor,         # (M, K), or (X, M, K) planes, G % X == 0
    r_hat,
) -> torch.Tensor:
    """Plain version of the bit-line kernel: the Thomas bottom currents of
    signed planes through conductance arrays.  Batched, array ``i`` takes
    plane batch ``i % X`` and the result is (G, M, N); unbatched, (M, N)
    (``core.parasitics.bitline_currents``)."""
    if g.ndim == 2:
        return bitline_currents(g, x, r_hat)
    n_g, n_x = g.shape[0], x.shape[0]
    planes = x.reshape((1, n_x) + tuple(x.shape[1:]))
    arrays = g.reshape((n_g // n_x, n_x) + tuple(g.shape[1:]))
    return _thomas_bottom_current(planes, arrays, r_hat).reshape(
        (n_g,) + (x.shape[1], g.shape[2]))


def analog_mvm_diff(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued
    g_pos: torch.Tensor,     # (P, rows, N)
    g_neg: torch.Tensor,     # (P, rows, N)
    *,
    adc_lo,
    adc_hi,
    adc_bits: int,
    gain: float,
) -> torch.Tensor:
    """Plain version of the legacy Design-A kernel: per partition the dot
    with ``g_pos - g_neg`` (rows ascending, as :func:`fused_pre_adc`), the
    value-unit ADC, ``* gain``, partitions summed in order from zero.
    Returns (M, N) code units."""
    m, p, _ = x_parts.shape
    dev = x_parts.device
    lo, hi = _scalars(dev, adc_lo, adc_hi)
    v = fused_pre_adc(x_parts, g_pos[None], g_neg[None], None)[:, 0, 0]
    out = torch.zeros((m, g_pos.shape[-1]), dtype=torch.float32, device=dev)
    for pi in range(p):
        out = out + _adc_epilogue(v[pi], lo, hi, adc_bits) * gain
    return out


def analog_mvm_bitserial(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued, signed
    g_pos: torch.Tensor,     # (P, rows, N)
    g_neg: torch.Tensor,     # (P, rows, N)
    *,
    n_bits: int,
    adc_lo,
    adc_hi,
    adc_bits: int,
    gain: float,
) -> torch.Tensor:
    """Plain version of the Design-D bit-serial kernel: per partition each
    signed bit plane's dot with ``g_pos - g_neg`` (rows ascending, as
    :func:`fused_pre_adc`), its value-unit ADC, the ``2**b`` shift-add (bits
    ascending, from zero), ``* gain``; partitions summed in order from zero
    (the kernel's order: the reference oracle sums partitions before bits).
    Returns (M, N) code units."""
    m, p, _ = x_parts.shape
    dev = x_parts.device
    lo, hi = _scalars(dev, adc_lo, adc_hi)
    v = fused_pre_adc(x_parts, g_pos[None], g_neg[None], n_bits)[:, 0]
    out = torch.zeros((m, g_pos.shape[-1]), dtype=torch.float32, device=dev)
    for pi in range(p):
        acc = torch.zeros_like(out)
        for b in range(n_bits):
            acc = acc + _adc_epilogue(v[pi, b], lo, hi, adc_bits) * 2.0 ** b
        out = out + acc * gain
    return out


def analog_mvm_parasitic_diff(
    x_parts: torch.Tensor,   # (M, P, rows) integer-valued, signed
    g_pos: torch.Tensor,     # (P, rows, N)
    g_neg: torch.Tensor,     # (P, rows, N)
    *,
    r_hat,
    n_bits: int,
    adc_lo,
    adc_hi,
    adc_bits: int,
    gain: float,
) -> torch.Tensor:
    """Plain version of the legacy parasitic Design-A kernel: per partition
    the analog bit fold of both lines' Thomas currents, the value-unit
    ADC, ``* gain``, partitions summed in order from zero.  Returns (M, N)
    code units."""
    m, p, _ = x_parts.shape
    dev = x_parts.device
    lo, hi = _scalars(dev, adc_lo, adc_hi)
    v = parasitic_pre_adc(x_parts, g_pos[None], g_neg[None], r_hat,
                          n_bits)[:, 0]                            # (P, M, N)
    out = torch.zeros((m, g_pos.shape[-1]), dtype=torch.float32, device=dev)
    for pi in range(p):
        out = out + _adc_epilogue(v[pi], lo, hi, adc_bits) * gain
    return out


def paged_attention_decode(
    q: torch.Tensor,          # (B, H, hd)
    k_pages: torch.Tensor,    # (P, page_size, KV, hd)
    v_pages: torch.Tensor,    # (P, page_size, KV, hd)
    ptab: torch.Tensor,       # (B, NP) int block table
    kv_len: torch.Tensor,     # (B,) valid positions per row
) -> torch.Tensor:
    """Decode attention over a paged KV pool, in the reference oracle's
    order: per page, the masked logits and the page's (denominator,
    numerator) terms against the global max; then a left fold over pages
    with pure adds.  Positions at or beyond ``kv_len[b]`` contribute
    exact zeros.  ``page_size == 1`` is canonicalized into one page per
    row, as in the reference."""
    b, h, hd = q.shape
    _, page_size, kv_heads, _ = k_pages.shape
    n_pages = ptab.shape[1]
    if page_size == 1 and n_pages > 1:
        tab = ptab.long()
        return paged_attention_decode(
            q, k_pages[:, 0][tab], v_pages[:, 0][tab],
            torch.arange(b, device=q.device)[:, None], kv_len)
    g = h // kv_heads
    scale = hd ** -0.5
    kv_len = kv_len.to(device=q.device, dtype=torch.int64)
    kp = k_pages.to(torch.float32)[ptab.long()]        # (B, NP, page, KV, hd)
    vp = v_pages.to(torch.float32)[ptab.long()]
    qg = q.to(torch.float32).reshape(b, kv_heads, g, hd) * scale
    s = torch.einsum("bkgd,bjpkd->bjkgp", qg, kp)      # (B, NP, KV, g, page)
    k_pos = (torch.arange(n_pages, device=q.device)[:, None] * page_size
             + torch.arange(page_size, device=q.device)[None, :])
    valid = k_pos[None] < kv_len[:, None, None]        # (B, NP, page)
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    m = s.amax(dim=(1, 4))                             # (B, KV, g)
    p = torch.exp(s - m[:, None, :, :, None])
    ls = p.sum(dim=-1)                                 # (B, NP, KV, g)
    accs = torch.einsum("bjkgp,bjpkd->bjkgd", p, vp)   # (B, NP, KV, g, hd)
    l = torch.zeros((b, kv_heads, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv_heads, g, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(n_pages):
        l = l + ls[:, j]
        acc = acc + accs[:, j]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


def flash_attention_decode(
    q: torch.Tensor,          # (B, H, hd)
    k: torch.Tensor,          # (B, S, KV, hd) dense per-slot cache
    v: torch.Tensor,          # (B, S, KV, hd)
    kv_len: torch.Tensor,     # (B,) valid positions per row
) -> torch.Tensor:
    """Plain version of the flash-decode kernel: the dense cache, zero-padded
    behind the mask to a multiple of :data:`FLASH_BLOCK` and chunked into
    blocks of that length, is a paged pool whose block table is
    ``row * n_blocks + j``, so this delegates to
    :func:`paged_attention_decode` (the reference oracle's page order)."""
    pad = (-k.shape[1]) % FLASH_BLOCK
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    b, seq, kv_heads, hd = k.shape
    n_blocks = seq // FLASH_BLOCK
    kp = k.reshape(b * n_blocks, FLASH_BLOCK, kv_heads, hd)
    vp = v.reshape(b * n_blocks, FLASH_BLOCK, kv_heads, hd)
    tab = (torch.arange(b, device=q.device)[:, None] * n_blocks
           + torch.arange(n_blocks, device=q.device)[None, :])
    return paged_attention_decode(q, kp, vp, tab, kv_len)
