"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is ``cuda``-marked and skips without a CUDA device;
on a machine with one (and nvcc) run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports torch and the port only, so it runs where JAX is not
installed.  Bounds (``repro_torch.kernels.tolerance``): the fused MVM, the
fused parasitic MVM, the legacy Design-A and the Design-D bit-serial
kernels within 2 ulp or 0.25 of a dequant grid step (or of ``gain``),
one-code ADC flips only where the pre-ADC value lies within 4 ulp of a
rounding edge; bit-line currents within 2 ulp of ``|I|``; flash decode and
paged attention within ``4 ulp + kv_len * eps * max|v|``, and the paged
kernel equal to the flash-decode kernel on the gathered view to the bit,
on the grids and on ``ATTN_EDGE_GRID``'s edges of the kernels' split of
positions over a cluster (chunk and span edges, 2048 to 32768 positions,
scratch and global-table paths, rows copied with plain loads); the
attention kernels' result depends on
each row's fill alone (not on the capacity, the batch, or a CUDA graph),
and a row of fill 0 gives its plain version's mean of v over the capacity.
The fused MVM kernel (both input modes), the legacy Design-A kernel and
the Design-D bit-serial kernel are also held to their plain versions to
the bit (``torch.equal``), on the grids and on the edges of their tiling:
row counts M in {1, 4, 40, 128} (row tiles of 4, 16 and 128), partitions
P in {1, 3, 6, 9} (9 runs two rounds of an 8-block cluster), N in {7,
130, 2560} (N % 4 != 0 takes the 4-byte copies) and array rows in {33,
854, 1152} (ragged stages).  The bit-line kernel is held to the bit too,
on its grid and on the edges of its tiling (``BITLINE_EDGE_GRID``), and
so are the fused parasitic and legacy parasitic Design-A kernels, on
their grids, on the edges of their tiling (``PARASITIC_EDGE_GRID``) and
on a 128-row batch split into rows and straddling slices.
The grids (``tolerance.*_GRID``) are those of ``tests/test_kernels.py``,
shared with ``tests/test_torch_kernels.py``,
``tests/test_torch_parasitics.py``, ``tests/test_torch_paged.py`` and
``chip_smoke.py``.

The sweep engine on the card: ``ServeEvaluator`` at the smoke config
with ``fused="kernel"`` equals ``serve_serial_reference`` metric for
metric, and a ``ClassifierEvaluator`` grid with ``fused="kernel"`` gives
the same accuracies with the fused MVM kernel swapped for its plain
version.

Drift, stuck-cell faults and healing on the card: at one full-width site
the fresh age leaves every conductance equal, the drift exponents taken
back out of the aged conductances and the stuck share follow their
formulas within 5 sigma of their draws, and a seed replays; forced healing
with aging that changes no value leaves the dense (flash kernel) and paged
(paged-attention kernel) runtimes' tokens as they were; and
``resilient_step`` re-raises a failed launch at once, with no retry.

The other families on the card: the fused MVM kernel equals its plain
version at rwkv6-3b's channel-mix shapes (N = 8960 and K = 8960, 4 and
128 rows); the MoE block gives the same bits on every run; the rwkv, MoE
and vlm smoke configs served on the kernel give the plain route's tokens.

Training data on the card: a ``SyntheticLM`` batch asked for the card
equals the CPU one's bits; ``core.errors.generator`` on the card draws
what the card's own generator draws (its meta-device branch aside).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.adc import range_from_samples
from repro_torch.kernels import fused as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import tolerance
from repro_torch.kernels import build
from repro_torch.kernels.tolerance import (ATTN_EDGE_GRID, BITLINE_GRID,
                                           BITSERIAL_GAIN,
                                           BITSERIAL_GRID, BITSERIAL_RANGE,
                                           FLASH_GRID, FUSED_GRID,
                                           FUSED_PARASITIC_GRID, LEGACY_GAIN,
                                           LEGACY_GRID, LEGACY_PARASITIC_GRID,
                                           LEGACY_RANGE, PAGED_GRID,
                                           attn_edge_case, bitline_case,
                                           bitserial_case,
                                           flash_case, fused_case,
                                           fused_parasitic_case, legacy_case,
                                           paged_case)
from repro_torch.kernels.ref import fused_pre_adc


def _ids(grid):
    return ["-".join(str(a) for a in case) for case in grid]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc for "
                    "sm_90a and run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,p,s,rows,n,n_bits,cell_bits", FUSED_GRID,
                         ids=_ids(FUSED_GRID))
def test_fused_mvm_kernel_matches_plain(cuda_device, m, p, s, rows, n, n_bits,
                                        cell_bits):
    t = [torch.as_tensor(a, device=cuda_device)
         for a in fused_case(m, p, s, rows, n)]
    kw = dict(adc_lo=t[3], adc_hi=t[4], adc_bits=8, cell_bits=cell_bits,
              n_bits=n_bits, scale=torch.tensor(3e-4, device=cuda_device))
    before = t_fused.LAUNCHES["fused_mvm"]
    y = t_ops.fused_mvm(*t[:3], backend="kernel", **kw)
    y_ref = t_ops.fused_mvm(*t[:3], backend="oracle", **kw)
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["fused_mvm"] == before + 1
    r = tolerance.fused_mvm_check(y, y_ref, *t, kw["scale"], adc_bits=8,
                                  cell_bits=cell_bits, n_bits=n_bits)
    assert r["ok"], r
    assert torch.equal(y, y_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,kv,g,hd", FLASH_GRID, ids=_ids(FLASH_GRID))
def test_flash_decode_kernel_matches_plain(cuda_device, b, s, kv, g, hd,
                                           dtype):
    q, k, v, fills = (torch.as_tensor(a, device=cuda_device)
                      for a in flash_case(b, s, kv, g, hd))
    k, v = k.to(getattr(torch, dtype)), v.to(getattr(torch, dtype))
    before = t_fused.LAUNCHES["flash_decode"]
    out = t_ops.flash_attention_decode(q, k, v, fills, backend="kernel")
    ref = t_ops.flash_attention_decode(q, k, v, fills, backend="oracle")
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["flash_decode"] == before + 1
    r = tolerance.flash_decode_check(out, ref, v, fills)
    assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits", [None, 7])
def test_fused_mvm_kernel_is_batch_invariant(cuda_device, n_bits):
    """Each output row is the same bits whichever rows share the launch,
    across the kernel's row tiles (M = 40 runs in one 128-row tile, or
    three 16-row tiles in bit-serial mode; a single row in a 4-row tile;
    rows 5:21 in a 16-row tile)."""
    x, gp, gm, lo, hi = (torch.as_tensor(a, device=cuda_device)
                         for a in fused_case(40, 2, 2, 96, 70, seed=3))
    kw = dict(adc_lo=lo, adc_hi=hi, adc_bits=8, cell_bits=2, n_bits=n_bits,
              scale=torch.tensor(3e-4, device=cuda_device), backend="kernel")
    full = t_ops.fused_mvm(x, gp, gm, **kw)
    for i in (0, 15, 16, 39):
        assert torch.equal(t_ops.fused_mvm(x[i:i + 1], gp, gm, **kw),
                           full[i:i + 1])
    assert torch.equal(t_ops.fused_mvm(x[5:21], gp, gm, **kw), full[5:21])


def _on(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,r", BITLINE_GRID, ids=_ids(BITLINE_GRID))
def test_bitline_kernel_matches_plain(cuda_device, m, k, n, r):
    x, g = _on(cuda_device, *bitline_case(m, k, n))
    before = t_fused.LAUNCHES["bitline_mvm"]
    got = t_ops.bitline_mvm(g, x, r)
    want = t_ops.bitline_mvm(g, x, r, backend="oracle")
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["bitline_mvm"] == before + 1
    res = tolerance.bitline_check(got, want)
    assert res["ok"], res
    assert torch.equal(got, want)


#: (X, G, M, K, N, r_hat) cases on the edges of the bit-line kernel's
#: tiling: K of 1 to 1152 around its 8-row batches and 128-row x stages,
#: plane rows M that are not a multiple of a thread's 4 or a block's 32,
#: N % 32 != 0, plane batches X < G broadcast over the arrays, and three
#: parasitic levels
BITLINE_EDGE_GRID = [(1, 1, 1, 1, 33, 1e-3), (1, 1, 7, 15, 45, 1e-4),
                     (1, 1, 9, 16, 7, 1e-5), (1, 2, 33, 17, 32, 1e-3),
                     (2, 4, 7, 255, 70, 1e-4), (1, 3, 9, 256, 33, 1e-5),
                     (3, 3, 40, 257, 100, 1e-4), (3, 6, 896, 854, 70, 1e-4),
                     (1, 2, 31, 1152, 65, 1e-3), (2, 2, 1, 1152, 257, 1e-5),
                     (3, 3, 896, 128, 2560, 1e-4), (2, 4, 9, 854, 31, 1e-5)]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,ng,m,k,n,r", BITLINE_EDGE_GRID,
                         ids=_ids(BITLINE_EDGE_GRID))
def test_bitline_kernel_equals_plain_on_tile_edges(cuda_device, nx, ng, m, k,
                                                   n, r):
    """Every (array, plane row, column) sweep equals the plain version to
    the bit on the edges of the kernel's tiling; signed planes with about
    40% zeros (signed zeros among them), conductances in [0, 1)."""
    rng = np.random.default_rng(m * 7 + k + n)
    x = (np.sign(rng.standard_normal((nx, m, k)))
         * (rng.random((nx, m, k)) > 0.4)).astype(np.float32)
    g = rng.random((ng, k, n)).astype(np.float32)
    x, g = _on(cuda_device, x, g)
    before = t_fused.LAUNCHES["bitline_mvm"]
    got = t_ops.bitline_mvm(g, x, r)
    want = t_ops.bitline_mvm(g, x, r, backend="oracle")
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["bitline_mvm"] == before + 1
    assert got.shape == (ng, m, n) and bool(torch.isfinite(got).all())
    res = tolerance.bitline_check(got, want)
    assert res["ok"], res
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_bitline_kernel_covers_every_array_in_one_launch(cuda_device):
    """(S * P) arrays driven by the P partitions' planes, as the composed
    chain calls it under use_pallas."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    g = torch.rand((6, 70, 45), generator=gen, device=cuda_device)
    x = torch.sign(torch.randn((3, 21, 70), generator=gen,
                               device=cuda_device))
    before = t_fused.LAUNCHES["bitline_mvm"]
    got = t_ops.bitline_mvm(g, x, 3e-4)
    assert t_fused.LAUNCHES["bitline_mvm"] == before + 1
    want = t_ops.bitline_mvm(g, x, 3e-4, backend="oracle")
    res = tolerance.bitline_check(got, want)
    assert res["ok"], res
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,p,s,rows,n,r", FUSED_PARASITIC_GRID,
                         ids=_ids(FUSED_PARASITIC_GRID))
def test_fused_parasitic_kernel_matches_plain(cuda_device, m, p, s, rows, n,
                                              r):
    x, gp, gm, lo, hi = _on(cuda_device, *fused_parasitic_case(m, p, s, rows,
                                                               n))
    kw = dict(r_hat=r, adc_lo=lo, adc_hi=hi, adc_bits=8,
              cell_bits=2 if s > 1 else 7, n_bits=7,
              scale=torch.tensor(3e-4, device=cuda_device))
    before = t_fused.LAUNCHES["fused_mvm_parasitic"]
    y = t_ops.fused_mvm_parasitic(x, gp, gm, **kw)
    y_ref = t_ops.fused_mvm_parasitic(x, gp, gm, backend="oracle", **kw)
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["fused_mvm_parasitic"] == before + 1
    res = tolerance.fused_mvm_parasitic_check(
        y, y_ref, x, gp, gm, r, lo, hi, kw["scale"], adc_bits=8,
        cell_bits=kw["cell_bits"], n_bits=7)
    assert res["ok"], res
    assert torch.equal(y, y_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m,p,rows,n", LEGACY_PARASITIC_GRID,
                         ids=_ids(LEGACY_PARASITIC_GRID))
def test_legacy_parasitic_kernel_matches_plain(cuda_device, m, p, rows, n):
    x, gp, gm = _on(cuda_device, *legacy_case(m, p, rows, n))
    lo, hi = (torch.tensor(v, device=cuda_device) for v in LEGACY_RANGE)
    kw = dict(r_hat=1e-3, n_bits=7, adc_lo=lo, adc_hi=hi, adc_bits=8,
              gain=LEGACY_GAIN)
    before = t_fused.LAUNCHES["analog_bitline_diff"]
    y = t_ops.analog_mvm_parasitic(x, gp, gm, **kw)
    y_ref = t_ops.analog_mvm_parasitic(x, gp, gm, backend="oracle", **kw)
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["analog_bitline_diff"] == before + 1
    res = tolerance.analog_mvm_check(y, y_ref, x, gp, gm, lo, hi, LEGACY_GAIN,
                                     adc_bits=8, r_hat=1e-3, n_bits=7)
    assert res["ok"], res
    assert torch.equal(y, y_ref)


#: (m, p, s, rows, n, n_bits, r_hat) cases on the edges of the parasitic
#: fold kernel's tiling: row counts M in {1, 3, 4, 5, 9, 130} (single rows,
#: ragged last row tiles, a prefill bucket), partitions P in {1, 3, 6, 9}
#: (9 runs two rounds of an 8-block cluster), S in {1, 2, 4} slices (the
#: fused kernel; the legacy one takes slice 0), n_bits in {1, 7, 8} (a
#: thread's systems padded where rows x bits is odd), array rows in {1,
#: 33, 854, 1152} around the 8-row batches and 128-row plane stages,
#: N % 32 != 0, and three parasitic levels
PARASITIC_EDGE_GRID = [(1, 1, 1, 1, 33, 1, 1e-3), (3, 3, 2, 33, 45, 1, 1e-4),
                       (4, 3, 1, 854, 70, 7, 1e-4),
                       (5, 6, 1, 1152, 31, 8, 1e-5),
                       (9, 9, 4, 33, 100, 7, 1e-3),
                       (130, 1, 1, 33, 65, 8, 1e-4),
                       (4, 9, 2, 1152, 7, 1, 1e-5),
                       (130, 3, 1, 854, 33, 7, 1e-4),
                       (1, 6, 4, 854, 257, 7, 1e-3),
                       (3, 1, 1, 1152, 130, 7, 1e-5),
                       (9, 3, 2, 1, 45, 7, 1e-4)]


def _parasitic_ranges(x, gp, gm, r_hat, n_bits):
    """Per-slice ADC ranges (S,) of the plain pre-ADC values."""
    from repro_torch.kernels.ref import parasitic_pre_adc

    v = parasitic_pre_adc(x, gp, gm, r_hat, n_bits)           # (P, S, M, N)
    lo, hi = zip(*(range_from_samples(v[:, s])
                   for s in range(gp.shape[0])))
    return torch.stack(lo), torch.stack(hi)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fused_mvm_parasitic",
                                   "analog_mvm_parasitic"])
@pytest.mark.parametrize("m,p,s,rows,n,n_bits,r", PARASITIC_EDGE_GRID,
                         ids=_ids(PARASITIC_EDGE_GRID))
def test_parasitic_kernels_equal_plain_on_tile_edges(cuda_device, m, p, s,
                                                     rows, n, n_bits, r,
                                                     which):
    """The fused parasitic kernel and the legacy parasitic Design-A kernel
    equal their plain versions to the bit on the edges of their tiling,
    with ADC ranges from the plain pre-ADC values (8-bit signed
    activations).  Where such a range is degenerate (lo == hi) the legacy
    epilogue's plain version gives NaN, and the kernel must give the same
    NaN; every other output is finite and equal."""
    x, gp, gm, _, _ = _on(cuda_device, *fused_case(m, p, s, rows, n,
                                                   seed=m + p + rows + n))
    x = x.clamp(-127, 127)
    if which == "fused_mvm_parasitic":
        lo, hi = _parasitic_ranges(x, gp, gm, r, n_bits)
        kw = dict(r_hat=r, adc_lo=lo, adc_hi=hi, adc_bits=8,
                  cell_bits=2 if s > 1 else 7, n_bits=n_bits,
                  scale=torch.tensor(3e-4, device=cuda_device))
        name = "fused_mvm_parasitic"
    else:
        gp, gm = gp[0], gm[0]
        lo, hi = _parasitic_ranges(x, gp[None], gm[None], r, n_bits)
        kw = dict(r_hat=r, n_bits=n_bits, adc_lo=lo[0], adc_hi=hi[0],
                  adc_bits=8, gain=LEGACY_GAIN)
        name = "analog_bitline_diff"
    f = getattr(t_ops, which)
    before = t_fused.LAUNCHES[name]
    y = f(x, gp, gm, **kw)
    y_ref = f(x, gp, gm, backend="oracle", **kw)
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES[name] == before + 1
    assert y.shape == (m, n)
    assert bool(torch.isfinite(y[torch.isfinite(y_ref)]).all())
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("m,p,rows,n,adc_bits", LEGACY_GRID,
                         ids=_ids(LEGACY_GRID))
def test_legacy_kernel_matches_plain(cuda_device, m, p, rows, n, adc_bits):
    x, gp, gm = _on(cuda_device, *legacy_case(m, p, rows, n, seed=m * 7 + p))
    lo, hi = (torch.tensor(v, device=cuda_device) for v in LEGACY_RANGE)
    kw = dict(adc_lo=lo, adc_hi=hi, adc_bits=adc_bits, gain=LEGACY_GAIN)
    before = t_fused.LAUNCHES["analog_mvm_diff"]
    y = t_ops.analog_mvm(x, gp, gm, **kw)
    y_ref = t_ops.analog_mvm(x, gp, gm, backend="oracle", **kw)
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["analog_mvm_diff"] == before + 1
    res = tolerance.analog_mvm_check(y, y_ref, x, gp, gm, lo, hi, LEGACY_GAIN,
                                     adc_bits=adc_bits)
    assert res["ok"], res
    assert torch.equal(y, y_ref)


#: (m, p, s, rows, n) cases on the edges of the streaming MVM kernel's
#: tiling: every M tile (1, 4 -> 4 rows; 40 -> 128; 128), cluster sizes
#: 1, 3, 6 and 9 partitions (two rounds of 8), N % 4 != 0 and a full tile,
#: ragged stages of 32 array rows, and two two-slice cases
MVM_EDGE_GRID = [(1, 1, 1, 33, 7), (1, 6, 1, 854, 2560), (1, 9, 1, 33, 130),
                 (4, 3, 1, 854, 2560), (4, 9, 1, 1152, 7),
                 (4, 6, 2, 33, 130), (40, 6, 1, 1152, 130),
                 (40, 1, 1, 33, 2560), (40, 9, 2, 854, 7),
                 (128, 9, 1, 33, 2560), (128, 3, 1, 854, 130),
                 (128, 1, 1, 1152, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["analog", "bitserial", "legacy",
                                  "bitserial_legacy"])
@pytest.mark.parametrize("m,p,s,rows,n", MVM_EDGE_GRID,
                         ids=_ids(MVM_EDGE_GRID))
def test_mvm_kernels_equal_plain_on_tile_edges(cuda_device, m, p, s, rows, n,
                                               mode):
    """The fused kernel in both input modes, the legacy Design-A kernel
    and the Design-D bit-serial kernel (slice 0, 7 bits, the ADC range of
    its per-bit pre-ADC values) equal their plain versions to the bit on
    the edges of their tiling."""
    x, gp, gm, lo, hi = _on(cuda_device, *fused_case(m, p, s, rows, n,
                                                     seed=m + p + rows))
    if mode == "legacy":
        x = x.clamp(-127, 127)
        kw = dict(adc_lo=lo[0], adc_hi=hi[0], adc_bits=8, gain=LEGACY_GAIN)
        name, f, gp, gm = "analog_mvm_diff", t_ops.analog_mvm, gp[0], gm[0]
    elif mode == "bitserial_legacy":
        x = x.clamp(-127, 127)
        lo, hi = range_from_samples(fused_pre_adc(x, gp[:1], gm[:1], 7))
        kw = dict(n_bits=7, adc_lo=lo, adc_hi=hi, adc_bits=8,
                  gain=BITSERIAL_GAIN)
        name, f = "analog_mvm_bitserial", t_ops.analog_mvm_bitserial
        gp, gm = gp[0], gm[0]
    else:
        kw = dict(adc_lo=lo, adc_hi=hi, adc_bits=8, cell_bits=2,
                  n_bits=7 if mode == "bitserial" else None,
                  scale=torch.tensor(3e-4, device=cuda_device))
        name, f = "fused_mvm", t_ops.fused_mvm
    before = t_fused.LAUNCHES[name]
    y = f(x, gp, gm, **kw)
    y_ref = f(x, gp, gm, backend="oracle", **kw)
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES[name] == before + 1
    assert y.shape == (m, n) and bool(torch.isfinite(y).all())
    assert torch.equal(y, y_ref)


#: row slices of a 128-row batch that straddle the streaming kernel's row
#: tiles (4, 16 and 128 rows, and 16 in bit-serial mode)
_STRADDLE = [(0, 4), (2, 6), (3, 19), (14, 30), (15, 33), (60, 128),
             (1, 128)]


def _rows_invariant(f, x, gp, gm, kw):
    """``f`` on a 128-row batch, on each of its rows alone, on the slices
    of ``_STRADDLE`` and inside a 136-row batch gives the same bits."""
    full = f(x, gp, gm, **kw)
    for i in range(x.shape[0]):
        assert torch.equal(f(x[i:i + 1], gp, gm, **kw), full[i:i + 1]), i
    for a, b in _STRADDLE:
        assert torch.equal(f(x[a:b], gp, gm, **kw), full[a:b]), (a, b)
    more = torch.cat([x, x[:8].flip(0)])
    assert torch.equal(f(more, gp, gm, **kw)[:128], full)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits", [None, 7])
def test_fused_mvm_kernel_is_batch_invariant_at_prefill_bucket(cuda_device,
                                                               n_bits):
    """A prefill bucket of 128 rows split into single rows and into slices
    across the row tiles: every row the same bits (three partitions, so a
    three-block cluster, and two slices)."""
    x, gp, gm, lo, hi = _on(cuda_device, *fused_case(128, 3, 2, 96, 70,
                                                     seed=4))
    kw = dict(adc_lo=lo, adc_hi=hi, adc_bits=8, cell_bits=2, n_bits=n_bits,
              scale=torch.tensor(3e-4, device=cuda_device))
    _rows_invariant(t_ops.fused_mvm, x, gp, gm, kw)


@pytest.mark.cuda
def test_legacy_kernel_is_batch_invariant_at_prefill_bucket(cuda_device):
    """The legacy Design-A kernel on the same 128-row batch split into
    single rows and slices across the row tiles."""
    x, gp, gm, lo, hi = _on(cuda_device, *fused_case(128, 3, 1, 96, 70,
                                                     seed=4))
    kw = dict(adc_lo=lo[0], adc_hi=hi[0], adc_bits=8, gain=LEGACY_GAIN)
    _rows_invariant(t_ops.analog_mvm, x.clamp(-127, 127), gp[0], gm[0], kw)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["analog_mvm_parasitic", "analog_mvm",
                                   "analog_mvm_bitserial"])
def test_legacy_epilogue_keeps_nan_of_degenerate_range(cuda_device, which):
    """With lo == hi the legacy epilogue has no guard: a pre-ADC value
    equal to lo is 0 / 0 in the reference and the plain version, NaN,
    and the kernels keep it (a row of zero activations); every other
    output equals the plain version's to the bit."""
    x, gp, gm = _on(cuda_device, *legacy_case(5, 2, 33, 45, seed=2))
    x[1] = 0.0
    zero = torch.tensor(0.0, device=cuda_device)
    kw = dict(adc_lo=zero, adc_hi=zero, adc_bits=8, gain=LEGACY_GAIN)
    if which == "analog_mvm_parasitic":
        kw.update(r_hat=1e-4, n_bits=7)
    if which == "analog_mvm_bitserial":
        kw.update(n_bits=7, gain=BITSERIAL_GAIN)
    f = getattr(t_ops, which)
    y = f(x, gp, gm, **kw)
    y_ref = f(x, gp, gm, backend="oracle", **kw)
    torch.cuda.synchronize()
    assert bool(y_ref[1].isnan().all())
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fused_mvm_parasitic",
                                   "analog_mvm_parasitic"])
def test_parasitic_kernels_are_batch_invariant_at_prefill_bucket(cuda_device,
                                                                 which):
    """The fused parasitic kernel (two slices) and the legacy parasitic
    Design-A kernel on a 128-row batch split into single rows and into
    slices across their row tiles: every row the same bits, whatever M
    and whichever tile it lands in (three partitions, so a three-block
    cluster)."""
    x, gp, gm, lo, hi = _on(cuda_device, *fused_case(128, 3, 2, 40, 45,
                                                     seed=5))
    x = x.clamp(-127, 127)
    if which == "fused_mvm_parasitic":
        kw = dict(r_hat=1e-4, adc_lo=lo, adc_hi=hi, adc_bits=8, cell_bits=2,
                  n_bits=7, scale=torch.tensor(3e-4, device=cuda_device))
    else:
        gp, gm = gp[0], gm[0]
        kw = dict(r_hat=1e-4, n_bits=7, adc_lo=lo[0], adc_hi=hi[0],
                  adc_bits=8, gain=LEGACY_GAIN)
    _rows_invariant(getattr(t_ops, which), x, gp, gm, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fused_mvm_parasitic",
                                   "analog_mvm_parasitic", "analog_mvm",
                                   "analog_mvm_bitserial"])
def test_new_mvm_kernels_are_batch_invariant(cuda_device, which):
    """Each output row is the same bits whichever rows share the launch
    (M = 40 runs in one 128-row tile of the legacy kernel, a single row in
    a 4-row tile, rows 5:21 in a 16-row tile)."""
    x, gp, gm, lo, hi = _on(cuda_device, *fused_case(40, 2, 1, 70, 45,
                                                     seed=3))
    x = x.clamp(-127, 127)
    if which == "fused_mvm_parasitic":
        kw = dict(r_hat=1e-4, adc_lo=lo, adc_hi=hi, adc_bits=8, cell_bits=7,
                  n_bits=7, scale=torch.tensor(3e-4, device=cuda_device))
    else:
        gp, gm = gp[0], gm[0]
        kw = dict(adc_lo=lo[0], adc_hi=hi[0], adc_bits=8, gain=LEGACY_GAIN)
        if which == "analog_mvm_parasitic":
            kw.update(r_hat=1e-4, n_bits=7)
        if which == "analog_mvm_bitserial":
            kw.update(n_bits=7, gain=BITSERIAL_GAIN)
    f = getattr(t_ops, which)
    full = f(x, gp, gm, **kw)
    for i in (0, 15, 16, 39):
        assert torch.equal(f(x[i:i + 1], gp, gm, **kw), full[i:i + 1])
    assert torch.equal(f(x[5:21], gp, gm, **kw), full[5:21])


@pytest.mark.cuda
def test_r_hat_and_gain_are_runtime_arguments(cuda_device):
    """A sweep over r_hat (and gain) runs the built libraries as they are:
    nothing rebuilds, and each level gives its own currents."""
    x, gp, gm = _on(cuda_device, *legacy_case(4, 2, 33, 9, seed=1))
    lo, hi = (torch.tensor(v, device=cuda_device) for v in LEGACY_RANGE)
    t_ops.analog_mvm_parasitic(x, gp, gm, r_hat=1e-5, n_bits=7, adc_lo=lo,
                               adc_hi=hi, adc_bits=8, gain=1.0)
    built = dict(build.PTXAS_REPORT)
    outs = [t_ops.analog_mvm_parasitic(x, gp, gm, r_hat=r, n_bits=7,
                                       adc_lo=lo, adc_hi=hi, adc_bits=8,
                                       gain=g)
            for r, g in ((1e-5, 2.0), (1e-3, 2.0), (1e-3, 3.0))]
    torch.cuda.synchronize()
    assert build.PTXAS_REPORT == built
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[1], outs[2])


def _paged_on(dev, case, seed=0):
    b, h, kv, hd, ps, npg, pool_dtype = case
    q, k, v, ptab, kv_len = _on(dev, *paged_case(b, h, kv, hd, ps, npg,
                                                 seed=seed))
    dt = getattr(torch, pool_dtype)
    return q, k.to(dt), v.to(dt), ptab, kv_len


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_GRID, ids=_ids(PAGED_GRID))
def test_paged_attention_kernel_matches_plain(cuda_device, case):
    q, k, v, ptab, kv_len = _paged_on(cuda_device, case)
    before = t_fused.LAUNCHES["paged_attention"]
    out = t_ops.paged_attention(q, k, v, ptab, kv_len)
    ref = t_ops.paged_attention(q, k, v, ptab, kv_len, backend="oracle")
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["paged_attention"] == before + 1
    res = tolerance.paged_attention_check(out, ref, v, ptab, kv_len)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_GRID, ids=_ids(PAGED_GRID))
def test_paged_attention_kernel_equals_flash_on_gathered_view(cuda_device,
                                                              case):
    """One summation order, set by kv_len alone: the paged kernel on a pool
    and a shuffled block table equals the flash-decode kernel on the dense
    view gathered from them, to the bit."""
    q, k, v, ptab, kv_len = _paged_on(cuda_device, case, seed=5)
    b, npg = ptab.shape
    _, ps, kv, hd = k.shape
    gk = k[ptab.long()].reshape(b, npg * ps, kv, hd).contiguous()
    gv = v[ptab.long()].reshape(b, npg * ps, kv, hd).contiguous()
    paged = t_ops.paged_attention(q, k, v, ptab, kv_len)
    flash = t_ops.flash_attention_decode(q, gk, gv, kv_len)
    torch.cuda.synchronize()
    assert torch.equal(paged, flash)


@pytest.mark.cuda
def test_paged_attention_kernel_ignores_table_tail(cuda_device):
    """Table entries past a row's fill (the sink, or any other page) are
    never read."""
    q, k, v, ptab, kv_len = _paged_on(cuda_device,
                                      (3, 4, 2, 8, 4, 4, "float32"), seed=1)
    base = t_ops.paged_attention(q, k, v, ptab, kv_len)
    tab = ptab.clone()
    for i, n in enumerate(kv_len.tolist()):
        tab[i, -(-n // 4):] = (i + 5) % tab.shape[1] + 1
    k2, v2 = k.clone(), v.clone()
    k2[0], v2[0] = float("nan"), float("nan")          # the sink page
    assert torch.equal(base, t_ops.paged_attention(q, k2, v2, tab, kv_len))


#: Design-D cases beyond the shared grid: nine partitions (two rounds of
#: the 8-block cluster) at M = 1, 4 and 40 (row tiles 4 and 16), N % 4 != 0
_BITSERIAL_P9 = [c + (nb,) for c in ((1, 9, 33, 130), (4, 9, 854, 7),
                                     (40, 9, 96, 70)) for nb in (4, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,p,rows,n,n_bits", BITSERIAL_GRID + _BITSERIAL_P9,
                         ids=_ids(BITSERIAL_GRID + _BITSERIAL_P9))
def test_bitserial_kernel_matches_plain(cuda_device, m, p, rows, n, n_bits):
    x, gp, gm = _on(cuda_device, *bitserial_case(m, p, rows, n, n_bits))
    lo, hi = (torch.tensor(v, device=cuda_device) for v in BITSERIAL_RANGE)
    kw = dict(n_bits=n_bits, adc_lo=lo, adc_hi=hi, adc_bits=8,
              gain=BITSERIAL_GAIN)
    before = t_fused.LAUNCHES["analog_mvm_bitserial"]
    y = t_ops.analog_mvm_bitserial(x, gp, gm, **kw)
    y_ref = t_ops.analog_mvm_bitserial(x, gp, gm, backend="oracle", **kw)
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["analog_mvm_bitserial"] == before + 1
    res = tolerance.bitserial_check(y, y_ref, x, gp, gm, lo, hi,
                                    BITSERIAL_GAIN, adc_bits=8, n_bits=n_bits)
    assert res["ok"], res
    assert torch.equal(y, y_ref)


@pytest.mark.cuda
def test_paged_kernel_server_agrees_with_decode_lm(cuda_device):
    """The smoke qwen1.5-4b (weights from a seed, an analog pack on the
    fused kernel) served through ``PagedServeRuntime(backend="kernel")``
    with prefix hits: the paged-attention kernel launches once per layer
    per decode step, and every request equals ``decode_lm`` except at a
    near tie (top-2 logit gap under 1e-4 of the logit scale)."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.models import transformer as T
    from repro_torch.serve import (PagedServeRuntime, calibrate_lm, decode_lm,
                                   program_lm)

    cfg = get_smoke_config("qwen1.5-4b")
    params = T.init_params(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(0)
    spec = A.design_a(error=E.state_proportional(0.05), fused="kernel")
    pack = calibrate_lm(cfg, params, program_lm(cfg, params, spec, seed=5),
                        torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)),
                                        device=cuda_device))
    shared = rng.integers(0, cfg.vocab, size=8)
    reqs = [(np.concatenate([shared, rng.integers(0, cfg.vocab, size=n)])
             .astype(np.int32), m) for n, m in ((4, 5), (6, 4), (2, 6),
                                                 (5, 3))]
    rt = PagedServeRuntime(cfg, params, pack=pack, max_slots=2, max_len=24,
                           page_size=4, backend="kernel")
    t_fused.reset_launch_counts()
    uids = [rt.submit(p, max_new_tokens=m) for p, m in reqs]
    outs = rt.run()
    rt.check()
    steps = rt.stats["decode_steps"]
    assert rt.stats["prefix_hits"] >= 1
    assert t_fused.LAUNCHES["paged_attention"] == cfg.n_layers * steps
    assert t_fused.LAUNCHES["flash_decode"] == 0
    for (p, m), uid in zip(reqs, uids):
        got = outs[uid]
        ref = decode_lm(cfg, params, torch.as_tensor(p, device=cuda_device)
                        [None], m, pack=pack)[0].cpu().numpy()
        diff = np.nonzero(ref != got)[0]
        if diff.size:
            seq = torch.as_tensor(np.concatenate([p, ref[:diff[0]]]),
                                  device=cuda_device)[None]
            lg = T.forward(cfg, params, seq, pack=pack)[0][0, -1]
            top2 = torch.topk(lg, 2).values
            assert float(top2[0] - top2[1]) < 1e-4 * float(lg.abs().max())


def _gathered(pool, ptab):
    b, npg = ptab.shape
    _, ps, kv, hd = pool.shape
    return pool[ptab.long()].reshape(b, npg * ps, kv, hd).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_EDGE_GRID, ids=_ids(ATTN_EDGE_GRID))
def test_attention_kernels_match_plain_on_edge_grid(cuda_device, case):
    """Both decode-attention kernels at the edges of their split of
    positions (fills 1, a chunk +- 1, one CTA's span +- 1, the capacity):
    within the bound of their plain versions, within the float64 bound of
    ``tolerance.attention_f64_check`` (which a kernel that left out a chunk
    of positions would fail where the first bound is loose, at 32768
    positions), and the paged kernel on a shuffled pool equal to the
    flash-decode kernel on the gathered view."""
    q, k, v, lens, kp, vp, ptab = attn_edge_case(*case, device=cuda_device)
    before = dict(t_fused.LAUNCHES)
    flash = t_ops.flash_attention_decode(q, k, v, lens)
    paged = t_ops.paged_attention(q, kp, vp, ptab, lens)
    on_view = t_ops.flash_attention_decode(q, _gathered(kp, ptab),
                                           _gathered(vp, ptab), lens)
    torch.cuda.synchronize()
    assert t_fused.LAUNCHES["flash_decode"] == before["flash_decode"] + 2
    assert t_fused.LAUNCHES["paged_attention"] == \
        before["paged_attention"] + 1
    r = tolerance.flash_decode_check(
        flash, t_ops.flash_attention_decode(q, k, v, lens, backend="oracle"),
        v, lens)
    assert r["ok"], r
    r = tolerance.paged_attention_check(
        paged, t_ops.paged_attention(q, kp, vp, ptab, lens, backend="oracle"),
        vp, ptab, lens)
    assert r["ok"], r
    for out in (flash, paged):
        r = tolerance.attention_f64_check(out, q, k, v, lens)
        assert r["ok"], r
    assert torch.equal(paged, on_view)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_attention_kernel_empty_row_gives_plain(cuda_device, paged):
    """A row of fill 0 has every logit at the mask value in the plain
    version, which then averages v over the capacity (the dense cache
    padded to its 8-position blocks, the pool's NP * page_size positions);
    the kernel gives the same.  The bound is the flash-decode bound with the
    capacity in place of that row's fill, since every position is summed."""
    if paged:
        q, k, v, ptab, lens = _paged_on(cuda_device,
                                        (3, 8, 2, 32, 8, 5, "bfloat16"))
        cap = ptab.shape[1] * k.shape[1]
    else:
        q, k, v, lens = (torch.as_tensor(a, device=cuda_device)
                         for a in flash_case(3, 300, 2, 4, 64, seed=4))
        cap = k.shape[1]
    lens[1] = 0
    if paged:
        out = t_ops.paged_attention(q, k, v, ptab, lens)
        ref = t_ops.paged_attention(q, k, v, ptab, lens, backend="oracle")
    else:
        out = t_ops.flash_attention_decode(q, k, v, lens)
        ref = t_ops.flash_attention_decode(q, k, v, lens, backend="oracle")
    torch.cuda.synchronize()
    assert bool(ref[1].abs().max() > 0)
    bound_lens = lens.clone()
    bound_lens[1] = cap
    r = (tolerance.paged_attention_check(out, ref, v, ptab, bound_lens)
         if paged else tolerance.flash_decode_check(out, ref, v, bound_lens))
    assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("s", [300, 2048])
def test_attention_kernel_is_capacity_invariant(cuda_device, s):
    """The same rows in a cache of S and of 2S positions (other cluster
    sizes and spans per CTA) give the same bits, dense and paged."""
    q, k, v, lens = (torch.as_tensor(a, device=cuda_device)
                     for a in flash_case(4, s, 2, 2, 128, seed=6))
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    lens[0] = s
    k2, v2 = torch.randn_like(torch.cat([k, k], 1).float()).to(k.dtype), \
        torch.randn_like(torch.cat([v, v], 1).float()).to(v.dtype)
    k2[:, :s], v2[:, :s] = k, v
    base = t_ops.flash_attention_decode(q, k, v, lens)
    assert torch.equal(base, t_ops.flash_attention_decode(q, k2, v2, lens))
    ps = 4
    pool_k, pool_v = (t.reshape(-1, ps, 2, 128) for t in (k2, v2))
    npg = 2 * s // ps
    tab = torch.arange(4 * npg, device=cuda_device, dtype=torch.int32) \
        .reshape(4, npg)
    assert torch.equal(base, t_ops.paged_attention(q, pool_k, pool_v, tab,
                                                   lens))
    assert torch.equal(base, t_ops.paged_attention(
        q, pool_k, pool_v, tab[:, :s // ps].contiguous(), lens))


@pytest.mark.cuda
def test_attention_kernel_is_batch_invariant(cuda_device):
    """A row alone gives the same bits as the same row in a batch of 4."""
    q, k, v, lens = (torch.as_tensor(a, device=cuda_device)
                     for a in flash_case(4, 2048, 2, 4, 128, seed=7))
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    full = t_ops.flash_attention_decode(q, k, v, lens)
    for i in range(4):
        assert torch.equal(full[i:i + 1], t_ops.flash_attention_decode(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], lens[i:i + 1]))


@pytest.mark.cuda
def test_attention_kernel_graph_capture_equals_eager(cuda_device):
    """A call captured in a CUDA graph and replayed equals an eager call,
    dense and paged, including a call whose logits go to the scratch."""
    q, k, v, lens, kp, vp, ptab = attn_edge_case(
        32768, 1, 8, 256, "float32", 1, device=cuda_device, seed=3)
    calls = (lambda: t_ops.flash_attention_decode(q, k, v, lens),
             lambda: t_ops.paged_attention(q, kp, vp, ptab, lens))
    eager = [f() for f in calls]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in calls]
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# drift, stuck-cell faults and healing on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_aging_at_a_full_width_site(cuda_device):
    """w_gate of qwen1.5-4b (2560 x 6912, Design A, 3 partitions of 854
    rows): a spec with drift and faults at t = 1 programs the conductances
    of the spec without them; at t = 64 the per-cell drift exponents taken
    back out of ``g_t / g`` have a log-mean within 5 sigma of log(0.2) and
    a spread within 0.005 of sigma_nu 0.3, the stuck share is within 5
    sigma of ``1 - exp(-rate (t - 1))`` with stuck cells at g_min or 1.0
    only, and the same seed replays."""
    import dataclasses

    from repro_torch.core import analog as A
    from repro_torch.core import errors as E

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randn((2560, 6912), generator=gen, device=cuda_device) * 0.02
    base = A.design_a(error=E.state_proportional(0.05))
    aging = dataclasses.replace(base, drift=E.power_law_drift(0.2, 0.3),
                                fault=E.stuck_faults(1e-2))
    fresh = A.program(w, base, seed=3)
    assert torch.equal(A.program(w, aging, seed=3).g_pos, fresh.g_pos)
    assert torch.equal(A.program(w, aging, seed=3).g_neg, fresh.g_neg)
    g = fresh.g_pos
    n = g.numel()
    drift = E.power_law_drift(0.2, sigma_nu=0.3)
    g_t = drift.apply(g, 64.0, seed=9)
    assert torch.equal(drift.apply(g, 1.0, seed=9), g)
    assert torch.equal(drift.apply(g, 64.0, seed=9), g_t)
    pos = g > 0
    log_nu = torch.log(-torch.log(g_t[pos].double() / g[pos].double())
                       / np.log(64.0))
    assert abs(float(log_nu.mean()) - np.log(0.2)) < 5 * 0.3 / np.sqrt(n)
    assert abs(float(log_nu.std()) - 0.3) < 0.005
    assert bool((g_t[pos] <= g[pos]).all())
    fault = E.stuck_faults(1e-2)
    g_lo = base.mapping.g_min
    g_f = fault.apply(g, 64.0, seed=9, g_lo=g_lo)
    assert torch.equal(fault.apply(g, 64.0, seed=9, g_lo=g_lo), g_f)
    assert torch.equal(fault.apply(g, 1.0, seed=9, g_lo=g_lo), g)
    stuck = g_f != g
    p = 1.0 - np.exp(-1e-2 * 63.0)
    assert abs(float(stuck.double().mean()) - p) < 5 * np.sqrt(
        p * (1 - p) / n)
    vals = g_f[stuck]
    assert bool(((vals == 1.0) | (vals == g_lo)).all())


def _smoke_serving(dev):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T

    cfg = get_smoke_config("qwen1.5-4b")
    params = T.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(1)
    calib = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)), device=dev)
    reqs = [(rng.integers(0, cfg.vocab, size=n).astype(np.int32), m)
            for n, m in ((5, 6), (9, 4), (3, 7), (7, 5))]
    return cfg, params, calib, reqs


@pytest.mark.cuda
def test_forced_heal_changes_no_token_on_the_card(cuda_device):
    """A manager whose aging changes no value (nu = 0, no programming
    error), healed at every step: the dense runtime on the flash-decode
    kernel and the paged runtime on the paged-attention kernel both serve
    the unhealed dense run's tokens, with heal events, reprogrammed bands
    and recalibrations."""
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.serve import (HealPolicy, PackManager,
                                   PagedServeRuntime, ServeRuntime)

    cfg, params, calib, reqs = _smoke_serving(cuda_device)
    m = PackManager(cfg, params, A.design_a(
        error=E.none(), drift=E.power_law_drift(0.0), fused="kernel"), 5,
        calib_tokens=calib)
    force = HealPolicy(check_every=1, loss_mult=0.0, loss_add=-1.0,
                       bands_per_step=1)

    def serve(rt):
        uids = [rt.submit(p, max_new_tokens=n) for p, n in reqs]
        outs = rt.run()
        return [outs[u] for u in uids]

    plain = serve(ServeRuntime(cfg, params, manager=m, attn_backend="flash",
                               max_slots=2, max_len=16))
    t_fused.reset_launch_counts()
    for rt in (ServeRuntime(cfg, params, manager=m, attn_backend="flash",
                            max_slots=2, max_len=16, heal=force),
               PagedServeRuntime(cfg, params, manager=m, backend="kernel",
                                 max_slots=2, max_len=16, page_size=4,
                                 heal=force)):
        for a, b in zip(serve(rt), plain):
            np.testing.assert_array_equal(a, b)
        s = rt.stats
        assert s["heal_events"] >= 1 and s["bands_reprogrammed"] >= 2
        assert s["recalibrations"] >= 1
    assert t_fused.LAUNCHES["flash_decode"] > 0
    assert t_fused.LAUNCHES["paged_attention"] > 0
    assert t_fused.LAUNCHES["fused_mvm"] > 0


@pytest.mark.cuda
def test_resilient_step_never_retries_a_failed_launch(cuda_device):
    """The fused MVM kernel over 65536 x 64 columns: its grid's second
    dimension (a block per 64 columns) passes CUDA's 65535, the launch
    fails, and ``resilient_step`` re-raises the wrapper's RuntimeError at
    once, with no retry.  The error is a launch error, not sticky: the
    same op at a legal width runs after it."""
    from repro_torch.runtime.fault import resilient_step

    n = 65536 * 64
    x = torch.ones((1, 1, 1), device=cuda_device)
    gp = torch.full((1, 1, 1, n), 0.5, device=cuda_device)
    gm = torch.zeros_like(gp)
    kw = dict(adc_lo=torch.tensor([-1.0], device=cuda_device),
              adc_hi=torch.tensor([1.0], device=cuda_device), adc_bits=8,
              cell_bits=8, n_bits=None,
              scale=torch.tensor(1.0, device=cuda_device))
    calls = []

    def launch():
        calls.append("call")
        y = t_ops.fused_mvm(x, gp, gm, backend="kernel", **kw)
        torch.cuda.synchronize()
        return y

    with pytest.raises(RuntimeError, match="CUDA error"):
        resilient_step(launch, max_retries=3, backoff_s=0.001,
                       on_retry=lambda *a: calls.append("retry"))
    assert calls == ["call"]
    y = t_ops.fused_mvm(x, gp[..., :128].contiguous(),
                        gm[..., :128].contiguous(), backend="kernel", **kw)
    torch.cuda.synchronize()
    assert y.shape == (1, 128) and bool(torch.isfinite(y).all())


@pytest.mark.cuda
def test_serve_sweep_on_the_card_equals_serial(cuda_device):
    """The executor's cached-codes path and the serial ``program_lm`` path
    run the same kernels on the same seeds: equal metrics."""
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.sweep import (Axis, ServeEvaluator, SweepSpec, run_sweep,
                                   serve_serial_reference)

    cfg, params, calib, _ = _smoke_serving(cuda_device)
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)),
                             device=cuda_device)
    targets = torch.roll(tokens, -1, dims=1)
    prompts = tokens[:, :6]
    ev = ServeEvaluator(cfg, params, calib, tokens, targets, prompts=prompts,
                        decode_new=4)
    sweep = SweepSpec(
        name="card", base=A.design_a(error=E.state_proportional(0.0),
                                     fused="kernel"),
        axes=(Axis("error.alpha", (0.02, 0.05)),), trials=2, seed=3)
    t_fused.reset_launch_counts()
    res = run_sweep(sweep, ev)
    assert t_fused.LAUNCHES["fused_mvm"] > 0
    for r, pt in zip(res, sweep.expand()):
        ref = serve_serial_reference(cfg, params, pt.spec, calib, tokens,
                                     targets, prompts=prompts, decode_new=4,
                                     trials=2, seed=3)
        assert r.values == ref, r.tag
        assert all(np.isfinite(v["loss"]) for v in r.values)


@pytest.mark.cuda
def test_classifier_sweep_kernel_route_equals_plain(cuda_device, monkeypatch):
    """A Design-A grid on the fused route: the fused MVM kernel and its
    plain version give the same accuracies, trial for trial."""
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.sweep import (Axis, ClassifierEvaluator, SweepSpec,
                                   run_sweep)

    rng = np.random.default_rng(4)
    dims = (64, 256, 128, 16)
    layers = [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
               * dims[i] ** -0.5, np.zeros(dims[i + 1], np.float32))
              for i in range(3)]
    xca = rng.standard_normal((64, 64)).astype(np.float32)
    xte = rng.standard_normal((256, 64)).astype(np.float32)
    yte = rng.integers(0, 16, 256)
    ev = ClassifierEvaluator(layers, xca, xte, yte, device=cuda_device)
    sweep = SweepSpec(
        name="card_cls",
        base=dataclasses.replace(A.design_a(
            error=E.state_proportional(0.0), fused="kernel"), max_rows=48),
        axes=(Axis("mapping.bits_per_cell", (None, 2)),
              Axis("error.alpha", (0.0, 0.05))), trials=2, seed=5)
    t_fused.reset_launch_counts()
    kernel = run_sweep(sweep, ev)
    assert t_fused.LAUNCHES["fused_mvm"] > 0
    fused_mvm = t_ops.fused_mvm

    def plain(*a, **kw):
        return fused_mvm(*a, **dict(kw, backend="oracle"))

    monkeypatch.setattr(t_ops, "fused_mvm", plain)
    t_fused.reset_launch_counts()
    oracle = run_sweep(sweep, ev)
    assert t_fused.LAUNCHES["fused_mvm"] == 0
    assert [r.values for r in kernel] == [r.values for r in oracle]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2560, 8960), (8960, 2560)],
                         ids=["rwkv_ck", "rwkv_cv"])
def test_fused_mvm_kernel_equals_plain_at_rwkv_sites(cuda_device, k, n):
    """B1 at rwkv6-3b's channel-mix shapes (``ck``: N = 8960; ``cv``: K =
    8960, eight partitions of 1152 rows), Design-A conductances of a
    random weight, M = 4 and 128 rows: equal to its plain version."""
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.core.quant import quantize_acts

    spec = A.design_a(error=E.state_proportional(0.05))
    gen = torch.Generator(device=cuda_device).manual_seed(k + n)
    w = torch.randn((k, n), generator=gen, device=cuda_device) * k ** -0.5
    aw = A.program(w, spec, seed=3)
    p, rows = spec.n_partitions(k), spec.rows_per_partition(k)
    m_ = spec.mapping
    for m in (4, 128):
        xq = quantize_acts(torch.randn((m, k), generator=gen,
                                       device=cuda_device), spec.input_bits)
        x = torch.nn.functional.pad(xq.values, (0, p * rows - k)) \
            .reshape(m, p, rows).contiguous()
        lo, hi = range_from_samples(fused_pre_adc(x, aw.g_pos, aw.g_neg,
                                                  None))
        scale = (m_.levels_per_cell - 1) / (1.0 - m_.g_min) * aw.w_scale \
            * xq.scale
        kw = dict(adc_lo=lo.reshape(1), adc_hi=hi.reshape(1), adc_bits=8,
                  cell_bits=7, n_bits=None, scale=scale)
        before = t_fused.LAUNCHES["fused_mvm"]
        y = t_ops.fused_mvm(x, aw.g_pos, aw.g_neg, backend="kernel", **kw)
        y_ref = t_ops.fused_mvm(x, aw.g_pos, aw.g_neg, backend="oracle", **kw)
        torch.cuda.synchronize()
        assert t_fused.LAUNCHES["fused_mvm"] == before + 1
        assert torch.equal(y, y_ref), m


@pytest.mark.cuda
def test_moe_block_is_deterministic_on_the_card(cuda_device):
    """The MoE dispatch and combine (a token's slots summed in ascending
    order, no float atomics): the same bits on every run, capacity
    overflowing or not, and the dense plain version's values when
    nothing drops."""
    from repro_torch.config import ModelConfig
    from repro_torch.models import mlp as M

    for cf, drops in ((8.0, False), (0.5, True)):
        cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=512,
                          n_heads=8, n_kv_heads=8, d_ff=512, vocab=64,
                          n_experts=16, top_k=4, moe_d_ff=256,
                          capacity_factor=cf)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        p = {n_: w[0] for n_, w in M.init_moe(gen, cfg, 1,
                                              cuda_device).items()}
        x = torch.randn((4, 64, 512), generator=gen, device=cuda_device)
        aux = {}
        y0, _ = M.moe_block(p, x, cfg, aux=aux)
        assert (float(aux["moe/drop_frac"]) > 0) == drops
        for _ in range(3):
            assert torch.equal(M.moe_block(p, x, cfg)[0], y0)
        if not drops:
            torch.testing.assert_close(y0, M.moe_block_dense_ref(p, x, cfg),
                                       rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-3b", "qwen3-moe-235b-a22b",
                                  "arctic-480b", "internvl2-26b"])
def test_family_serves_through_kernel_as_plain_route(cuda_device, arch):
    """The rwkv, MoE and vlm smoke configs programmed, calibrated and
    served through ``decode_lm`` on the fused MVM kernel: the plain
    route's tokens, and the kernel launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import analog as A
    from repro_torch.core import errors as E
    from repro_torch.models.registry import get_model
    from repro_torch.serve import calibrate_lm, decode_lm, program_lm

    cfg = get_smoke_config(arch)
    params = get_model(cfg).init_params(cfg, 0, device=cuda_device)
    spec = A.design_a(error=E.state_proportional(0.05), fused="kernel")
    rng = np.random.default_rng(1)
    calib = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)),
                            device=cuda_device)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 7)),
                              device=cuda_device)
    pack = calibrate_lm(cfg, params, program_lm(cfg, params, spec, seed=7),
                        calib)
    t_fused.reset_launch_counts()
    toks = decode_lm(cfg, params, prompts, 6, pack=pack)
    assert t_fused.LAUNCHES["fused_mvm"] > 0
    plain = dataclasses.replace(
        pack, band_specs=tuple(
            type(ss)(tuple((n_, dataclasses.replace(s_, fused="oracle"))
                           for n_, s_ in ss.items))
            for ss in pack.band_specs),
        head_spec=dataclasses.replace(pack.head_spec, fused="oracle"))
    assert torch.equal(toks, decode_lm(cfg, params, prompts, 6, pack=plain))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lm", "uniform"])
def test_synthetic_batches_equal_on_cpu_and_card(cuda_device, mode):
    """``SyntheticLM`` draws on the CPU and moves the batch: a dataset asked
    for the card gives a CPU one's bits, prefix embeddings included."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import SyntheticLM

    cfg = get_smoke_config("internvl2-26b")
    on_cpu = SyntheticLM(cfg, 32, 4, seed=3, mode=mode, device="cpu")
    on_card = SyntheticLM(cfg, 32, 4, seed=3, mode=mode)
    for step in (0, 7, 123):
        a, b = on_cpu.batch(step), on_card.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert b[k].device.type == "cuda"
            assert torch.equal(a[k], b[k].cpu()), (step, k)


# ---------------------------------------------------------------------------
# the analyzer's contracts and the scalar-div forms on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_decode_launches_fixed_on_the_card(cuda_device):
    """``serve/decode-launches-fixed`` at smoke size on a Design-A pack:
    every decode step launches 7·L+1 ``fused_mvm`` and L ``flash_decode``,
    counted by ``kernels.fused.LAUNCHES``."""
    from repro_torch.analysis import check_contract
    from repro_torch.analysis import repo_contracts as R

    cfg, params, pack = R.serve_vehicle("cuda")
    t_fused.reset_launch_counts()
    _, rec, built = R.serve_dense((cfg, params, pack))
    want = {"fused_mvm": 7 * cfg.n_layers + 1, "flash_decode": cfg.n_layers}
    assert len(rec.decode) > 5 and all(d == want for d in rec.decode)
    assert t_fused.LAUNCHES["flash_decode"] == cfg.n_layers * len(rec.decode)
    assert built == {("linear", 1, 7, 8, None, None)}
    assert check_contract(R.decode_launches_contract(device="cuda"),
                          "trace") == []


@pytest.mark.cuda
def test_paged_decode_launches_fixed_on_the_card(cuda_device):
    from repro_torch.analysis import check_contract
    from repro_torch.analysis import repo_contracts as R

    cfg, params, pack = R.serve_vehicle("cuda")
    t_fused.reset_launch_counts()
    rt, rec = R.serve_paged((cfg, params, pack))
    want = {"fused_mvm": 7 * cfg.n_layers + 1,
            "paged_attention": cfg.n_layers}
    assert all(d == want for d in rec.decode)
    assert t_fused.LAUNCHES["paged_attention"] \
        == cfg.n_layers * len(rec.decode)
    assert rec.prefill_violations("paged") == []
    assert rt.stats["prefix_hits"] > 0 and rt.stats["cache_evictions"] > 0
    for c in R.paged_contracts(device="cuda"):
        assert check_contract(c, "trace") == [], c.name


@pytest.mark.cuda
def test_second_build_runs_no_nvcc(cuda_device):
    build.build_all()
    before = build.BUILDS
    assert build.build_all() == 0.0
    assert build.BUILDS == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [0.7, 56, 30, 1280])
def test_scalar_division_on_the_card(cuda_device, d):
    """On the card ``x / d`` by a Python number is a multiply by the
    float32 reciprocal — ``core.quant.div_as_compiled``'s form, which is
    what the reference's compiled division computes — and not the float64
    quotient rounded to float32 (the CPU's IEEE division).  The scalar-div
    repairs therefore leave every result on the card unchanged."""
    from repro_torch.core.quant import div_as_compiled

    x = torch.linspace(-64.0, 64.0, 1 << 16, dtype=torch.float32)
    on_card = (x.to(cuda_device) / d).cpu()
    chosen = div_as_compiled(x.to(cuda_device), d).cpu()
    assert torch.equal(on_card, chosen)
    assert torch.equal(chosen, div_as_compiled(x, d))
    quotient = (x.double() / float(torch.tensor(d, dtype=torch.float32))) \
        .to(torch.float32)
    assert torch.equal(x / d, quotient)
    assert not torch.equal(on_card, quotient)


@pytest.mark.cuda
def test_generator_on_the_card_draws_as_before(cuda_device):
    """``core.errors.generator`` makes a CPU generator only for the meta
    device: on the card it is still the card's own generator, drawing what
    ``torch.Generator(device="cuda")`` with the same seed draws."""
    from repro_torch.core.errors import generator

    g = generator(11, cuda_device)
    assert g.device.type == "cuda"
    got = torch.randn(4096, generator=g, device=cuda_device)
    want = torch.randn(4096, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(11))
    assert torch.equal(got, want)
