"""The fused serving kernels and their launchers (counterpart of
``repro.kernels.fused``).

* :func:`fused_mvm_cuda` — ``csrc/fused_mvm.cu``, replacing
  ``repro.kernels.fused.fused_mvm_pallas``: the whole differential analog
  chain of one matmul site (bit planes, dot with ``g_pos - g_neg``,
  calibrated ADC in code units, shift-and-add, partition sum, dequant) in
  one launch.
* :func:`fused_mvm_parasitic_cuda` — ``csrc/fused_mvm_parasitic.cu``,
  replacing ``repro.kernels.fused.fused_mvm_parasitic_pallas``: the same
  chain under bit-line parasitics (a Thomas sweep of every bit plane down
  both lines, the analog bit fold, one ADC per slice) in one launch.
* :func:`flash_decode_cuda` — ``csrc/flash_decode.cu``, replacing
  ``repro.kernels.fused.flash_attention_pallas``: single-token decode
  attention over the dense per-slot KV cache, masked by per-row fills,
  its positions split over a thread-block cluster per (row, KV head).

Each launcher checks device, dtype, shape and contiguity, allocates its
output, launches on PyTorch's current stream, raises if the launch was
refused, and adds one to its count in :data:`LAUNCHES` (which also counts
the launchers of ``kernels.paged``, ``kernels.bitline`` and
``kernels.analog_mvm``).  The
plain PyTorch versions live in ``kernels.ref``; ``kernels.ops`` picks
between them by device.  The epilogue helpers below are the reference's,
shared with the plain version so the two cannot diverge.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.core.quant import true_div
from repro_torch.kernels import build

#: launches of each kernel of the package since the last
#: :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"fused_mvm": 0, "flash_decode": 0,
                            "paged_attention": 0, "fused_mvm_parasitic": 0,
                            "bitline_mvm": 0, "analog_bitline_diff": 0,
                            "analog_mvm_diff": 0, "analog_mvm_bitserial": 0}

#: kernel limits (the CUDA sources size their register tiles by these)
MAX_SLICES = 8
MAX_BITS = 8
MAX_GROUP = 8
MAX_HEAD_DIM = 256


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def adc_lsb(lo, hi, bits: int):
    """ADC step size with the ``core.adc`` degenerate-range guard."""
    lsb = true_div(hi - lo, 2 ** bits - 1)
    return torch.where(lsb <= 0, torch.ones_like(lsb), lsb)


def fused_adc_code_units(v, lo, lsb, bits: int):
    """Clip/quantize to ``2**bits`` levels, returning the dequantized value
    in code units (``lo / lsb + code``), so the accumulation that follows
    is fed only by adds and exact power-of-two multiplies."""
    n_levels = 2 ** bits
    code = torch.clamp(torch.round((v - lo) / lsb), 0.0, n_levels - 1.0)
    return lo / lsb + code


def term_weight(cell_bits: int, s: int, b) -> float:
    """Shift-and-add weight of slice ``s``, input bit ``b`` (``None`` for
    the analog-accumulation single term) — an exact power of two."""
    return 2.0 ** (cell_bits * s + (0 if b is None else b))


def _bit_plane(mag, sign, b: int):
    """Signed bit plane ``b`` of float-encoded integers: bit b of |x|
    carrying sign(x)."""
    return (torch.floor(mag / 2.0 ** b) % 2.0) * sign


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _require(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _mvm_shapes(x_parts: torch.Tensor, g_pos: torch.Tensor,
                g_neg: torch.Tensor, *, sliced: bool):
    """Check an analog MVM's operands — float32, contiguous, on one CUDA
    device; x_parts (M, P, rows), g_pos and g_neg alike, (S, P, rows, N)
    if ``sliced`` else (P, rows, N) — and return
    ``(device, M, P, rows, N)``."""
    dev = x_parts.device
    if dev.type != "cuda":
        raise ValueError(f"the MVM kernels need CUDA tensors, got {dev}")
    for t, name in ((x_parts, "x_parts"), (g_pos, "g_pos"), (g_neg, "g_neg")):
        _require(t, name, torch.float32, dev)
    m, p, rows = x_parts.shape
    if (g_pos.ndim != (4 if sliced else 3)
            or tuple(g_pos.shape[-3:-1]) != (p, rows)
            or tuple(g_neg.shape) != tuple(g_pos.shape)):
        raise ValueError(
            f"shape mismatch: x_parts {tuple(x_parts.shape)}, g_pos "
            f"{tuple(g_pos.shape)}, g_neg {tuple(g_neg.shape)}")
    return dev, m, p, rows, g_pos.shape[-1]


def _scalar(v, device) -> torch.Tensor:
    """``v`` (a number or a one-element tensor) as a float32 (1,) tensor
    on ``device``."""
    return torch.as_tensor(v, device=device).to(torch.float32).reshape(1) \
        .contiguous()


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


_FUSED_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_PARASITIC_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
_FLASH_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
               + [ctypes.c_float, ctypes.c_void_p])
_SCRATCH_ARGS = [ctypes.c_int] * 7


def _lib(name: str, entries, argtypes) -> ctypes.CDLL:
    lib = build.load(name)
    for entry in entries:
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _scratch_bytes(lib: ctypes.CDLL, *shape: int) -> int:
    """``repro_decode_scratch_bytes`` of one call shape, asked once."""
    fn = lib.repro_decode_scratch_bytes
    fn.argtypes = _SCRATCH_ARGS
    fn.restype = ctypes.c_longlong
    return int(fn(*shape))


def decode_scratch(lib: ctypes.CDLL, b: int, capacity: int, kv_heads: int,
                   group: int, hd: int, k: torch.Tensor,
                   page_size: int) -> torch.Tensor:
    """The global scratch a decode-attention launch writes before it reads:
    every chunk's partial sums, and the logits of CTAs whose positions do
    not fit their shared memory (``csrc/flash_decode.cu``; ``page_size`` 0
    for the dense cache)."""
    n = _scratch_bytes(lib, b, capacity, kv_heads, group, hd,
                       k.element_size(), page_size)
    return torch.empty(n, dtype=torch.uint8, device=k.device)


def fused_mvm_cuda(
    x_parts: torch.Tensor,   # (M, P, rows) float32, integer-valued
    g_pos: torch.Tensor,     # (S, P, rows, N) float32
    g_neg: torch.Tensor,     # (S, P, rows, N) float32
    adc_lo: torch.Tensor,    # (S,)
    adc_hi: torch.Tensor,
    scale: torch.Tensor,     # scalar: gain * w_scale * x_scale
    *,
    adc_bits: int,
    cell_bits: int,
    n_bits: Optional[int],   # None = analog input accumulation
) -> torch.Tensor:
    """Launch the fused analog MVM kernel; returns the dequantized (M, N)."""
    dev, m, p, rows, n = _mvm_shapes(x_parts, g_pos, g_neg, sliced=True)
    s = g_pos.shape[0]
    if not 1 <= s <= MAX_SLICES:
        raise ValueError(f"fused_mvm takes 1..{MAX_SLICES} slices, got {s}")
    if n_bits is not None and not 1 <= n_bits <= MAX_BITS:
        raise ValueError(f"fused_mvm takes n_bits in 1..{MAX_BITS} or None, "
                         f"got {n_bits}")
    if not 1 <= adc_bits <= 24 or cell_bits * (s - 1) > 100:
        raise ValueError(f"adc_bits={adc_bits}, cell_bits={cell_bits} out "
                         "of the kernel's float32 range")
    lo = adc_lo.to(device=dev, dtype=torch.float32).reshape(s).contiguous()
    hi = adc_hi.to(device=dev, dtype=torch.float32).reshape(s).contiguous()
    sc = _scalar(scale, dev)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return y
    lib = _lib("fused_mvm", ("repro_fused_mvm",), _FUSED_ARGS)
    with torch.cuda.device(dev):
        rc = lib.repro_fused_mvm(
            _ptr(x_parts), _ptr(g_pos), _ptr(g_neg), _ptr(lo), _ptr(hi),
            _ptr(sc), _ptr(y), m, p, rows, n, s,
            0 if n_bits is None else int(n_bits), int(adc_bits),
            int(cell_bits), _stream(dev))
    _check_launch(rc, "fused_mvm")
    LAUNCHES["fused_mvm"] += 1
    return y


def fused_mvm_parasitic_cuda(
    x_parts: torch.Tensor,   # (M, P, rows) float32, integer-valued
    g_pos: torch.Tensor,     # (S, P, rows, N) float32
    g_neg: torch.Tensor,     # (S, P, rows, N) float32
    r_hat: torch.Tensor,     # scalar parasitic level
    adc_lo: torch.Tensor,    # (S,)
    adc_hi: torch.Tensor,
    scale: torch.Tensor,     # scalar: gain * w_scale * x_scale
    *,
    adc_bits: int,
    cell_bits: int,
    n_bits: int,
) -> torch.Tensor:
    """Launch the fused parasitic MVM kernel; returns the dequantized
    (M, N)."""
    dev, m, p, rows, n = _mvm_shapes(x_parts, g_pos, g_neg, sliced=True)
    s = g_pos.shape[0]
    if not 1 <= s <= MAX_SLICES:
        raise ValueError(
            f"fused_mvm_parasitic takes 1..{MAX_SLICES} slices, got {s}")
    if not 1 <= n_bits <= MAX_BITS:
        raise ValueError(
            f"fused_mvm_parasitic takes n_bits in 1..{MAX_BITS}, got {n_bits}")
    if not 1 <= adc_bits <= 24 or cell_bits * (s - 1) > 100 or m > 65535:
        raise ValueError(f"adc_bits={adc_bits}, cell_bits={cell_bits}, "
                         f"M={m} out of the kernel's range")
    r = _scalar(r_hat, dev)
    lo = adc_lo.to(device=dev, dtype=torch.float32).reshape(s).contiguous()
    hi = adc_hi.to(device=dev, dtype=torch.float32).reshape(s).contiguous()
    sc = _scalar(scale, dev)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return y
    lib = _lib("fused_mvm_parasitic", ("repro_fused_mvm_parasitic",),
               _PARASITIC_ARGS)
    with torch.cuda.device(dev):
        rc = lib.repro_fused_mvm_parasitic(
            _ptr(x_parts), _ptr(g_pos), _ptr(g_neg), _ptr(r), _ptr(lo),
            _ptr(hi), _ptr(sc), _ptr(y), m, p, rows, n, s, int(n_bits),
            int(adc_bits), int(cell_bits), _stream(dev))
    _check_launch(rc, "fused_mvm_parasitic")
    LAUNCHES["fused_mvm_parasitic"] += 1
    return y


def flash_decode_cuda(
    q: torch.Tensor,         # (B, H, hd)
    k: torch.Tensor,         # (B, S, KV, hd) float32 or bfloat16
    v: torch.Tensor,         # (B, S, KV, hd) same dtype as k
    kv_len: torch.Tensor,    # (B,) valid positions per row
) -> torch.Tensor:
    """Launch the flash-decode kernel (scores scaled by ``hd ** -0.5``);
    returns float32 (B, H, hd)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_decode_cuda needs CUDA tensors, got {dev}")
    _require(k, "k", (torch.float32, torch.bfloat16), dev)
    _require(v, "v", k.dtype, dev)
    b, h, hd = q.shape
    b2, seq, kv_heads, hd2 = k.shape
    if (b2, hd2) != (b, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if h % kv_heads:
        raise ValueError(f"{h} query heads not divisible by {kv_heads} "
                         "KV heads")
    if h // kv_heads > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode takes <= {MAX_GROUP} query heads "
                         f"per KV head and hd <= {MAX_HEAD_DIM}")
    qf = q.to(torch.float32).contiguous()
    lens = kv_len.to(device=dev, dtype=torch.int32).reshape(b).contiguous()
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    entry = ("repro_flash_decode_f32" if k.dtype == torch.float32
             else "repro_flash_decode_bf16")
    lib = _lib("flash_decode",
               ("repro_flash_decode_f32", "repro_flash_decode_bf16"),
               _FLASH_ARGS)
    scratch = decode_scratch(lib, b, seq, kv_heads, h // kv_heads, hd, k, 0)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            _ptr(qf), _ptr(k), _ptr(v), _ptr(lens), _ptr(out),
            _ptr(scratch), b, seq, h, kv_heads, hd, hd ** -0.5,
            _stream(dev))
    _check_launch(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out
