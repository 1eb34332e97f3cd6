"""Launchers of the parasitic bit-line kernels (counterpart of
``repro.kernels.bitline``).

* :func:`bitline_mvm_cuda` — ``csrc/bitline.cu``, replacing
  ``repro.kernels.bitline.bitline_mvm_pallas``: signed input planes through
  the parasitic circuit of conductance arrays, the Thomas forward sweep
  down every column to the bottom-node current — every (array, plane row,
  column) system in one launch.
* :func:`analog_bitline_diff_cuda` — ``csrc/fused_mvm_parasitic.cu`` (the
  fused parasitic kernel with the legacy epilogue), replacing
  ``repro.kernels.bitline.analog_bitline_diff_pallas``: the legacy unsliced
  Design A under parasitics (per partition both lines solved for every
  input bit, the analog bit fold, one value-unit ADC, ``* gain``, the sum
  over partitions), returning code units.

Each launcher checks device, dtype, shape and contiguity, allocates its
output, launches on PyTorch's current stream, raises if the launch was
refused, and adds one to its count in ``kernels.fused.LAUNCHES``.  The
plain versions are ``kernels.ref.bitline_mvm`` and
``kernels.ref.analog_mvm_parasitic_diff``.  ``r_hat`` and ``gain`` are
runtime arguments: a sweep over them does not rebuild.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fused import (LAUNCHES, MAX_BITS, _check_launch,
                                       _lib, _mvm_shapes, _ptr, _require,
                                       _scalar, _stream)

_BITLINE_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DIFF_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                             ctypes.c_void_p])
#: plane rows one bitline_mvm block sweeps (``kTileM`` in bitline.cu); the
#: grid's y dimension counts these tiles, its z dimension the arrays
_BITLINE_TILE_M = 32
_GRID_LIMIT = 65535


def bitline_mvm_cuda(
    g: torch.Tensor,         # (G, K, N) float32 conductance arrays
    x: torch.Tensor,         # (X, M, K) float32 signed planes, G % X == 0
    r_hat: torch.Tensor,     # scalar parasitic level
) -> torch.Tensor:
    """Launch the bit-line kernel: array ``i`` takes plane batch ``i % X``;
    returns the bottom-node currents (G, M, N)."""
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"bitline_mvm_cuda needs CUDA tensors, got {dev}")
    _require(g, "g", torch.float32, dev)
    _require(x, "x", torch.float32, dev)
    n_g, k, n = g.shape
    n_x, m, k2 = x.shape
    if k2 != k or n_x < 1 or n_g % n_x:
        raise ValueError(f"shape mismatch: g {tuple(g.shape)}, x "
                         f"{tuple(x.shape)}")
    if n_g > _GRID_LIMIT or -(-m // _BITLINE_TILE_M) > _GRID_LIMIT:
        raise ValueError(f"bitline_mvm takes at most {_GRID_LIMIT} arrays "
                         f"and {_GRID_LIMIT * _BITLINE_TILE_M} plane rows, "
                         f"got {n_g} and {m}")
    r = _scalar(r_hat, dev)
    out = torch.empty((n_g, m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib("bitline", ("repro_bitline_mvm",), _BITLINE_ARGS)
    with torch.cuda.device(dev):
        rc = lib.repro_bitline_mvm(_ptr(x), _ptr(g), _ptr(r), _ptr(out), n_x,
                                   n_g, m, k, n, _stream(dev))
    _check_launch(rc, "bitline_mvm")
    LAUNCHES["bitline_mvm"] += 1
    return out


def analog_bitline_diff_cuda(
    x_parts: torch.Tensor,   # (M, P, rows) float32, integer-valued
    g_pos: torch.Tensor,     # (P, rows, N) float32
    g_neg: torch.Tensor,     # (P, rows, N) float32
    r_hat: torch.Tensor,     # scalar parasitic level
    adc_lo: torch.Tensor,    # scalar / (1,) calibrated range
    adc_hi: torch.Tensor,
    *,
    n_bits: int,
    adc_bits: int,
    gain: float,
) -> torch.Tensor:
    """Launch the legacy parasitic Design-A kernel; returns (M, N) code
    units."""
    dev, m, p, rows, n = _mvm_shapes(x_parts, g_pos, g_neg, sliced=False)
    if not 1 <= n_bits <= MAX_BITS:
        raise ValueError(
            f"analog_bitline_diff takes n_bits in 1..{MAX_BITS}, got {n_bits}")
    if not 1 <= adc_bits <= 24 or m > 65535:
        raise ValueError(f"adc_bits={adc_bits}, M={m} out of the kernel's "
                         "range")
    r, lo, hi = (_scalar(v, dev) for v in (r_hat, adc_lo, adc_hi))
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return y
    lib = _lib("fused_mvm_parasitic", ("repro_analog_bitline_diff",),
               _DIFF_ARGS)
    with torch.cuda.device(dev):
        rc = lib.repro_analog_bitline_diff(
            _ptr(x_parts), _ptr(g_pos), _ptr(g_neg), _ptr(r), _ptr(lo),
            _ptr(hi), _ptr(y), m, p, rows, n, int(n_bits), int(adc_bits),
            float(gain), _stream(dev))
    _check_launch(rc, "analog_bitline_diff")
    LAUNCHES["analog_bitline_diff"] += 1
    return y
