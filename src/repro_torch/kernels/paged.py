"""The paged-attention kernel's launcher (counterpart of
``repro.kernels.paged``).

:func:`paged_attention_cuda` launches ``repro_paged_decode_{f32,bf16}`` of
``csrc/flash_decode.cu`` (the flash-decode kernel with a paged addressing
policy), replacing ``repro.kernels.paged.paged_attention_pallas``:
single-token GQA decode attention whose K/V rows are read through a
``(B, NP)`` block table from a ``(P, page_size, KV, hd)`` pool, masked by
the per-row fill.  The pool is read in its own dtype (float32 or
bfloat16): unlike the reference's wrapper, nothing casts it to float32
first.  The launcher checks its operands, allocates the output, launches
on PyTorch's current stream, raises if the launch was refused, and adds one
to its count in ``kernels.fused.LAUNCHES``.  The plain version is
``kernels.ref.paged_attention_decode``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fused import (LAUNCHES, MAX_GROUP, MAX_HEAD_DIM,
                                       _check_launch, _lib, _ptr, _require,
                                       _stream, decode_scratch)

_PAGED_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
               + [ctypes.c_float, ctypes.c_void_p])
_ENTRIES = ("repro_paged_decode_f32", "repro_paged_decode_bf16")


def paged_attention_cuda(
    q: torch.Tensor,          # (B, H, hd)
    k_pages: torch.Tensor,    # (P, page_size, KV, hd) float32 or bfloat16
    v_pages: torch.Tensor,    # (P, page_size, KV, hd) same dtype
    ptab: torch.Tensor,       # (B, NP) block table
    kv_len: torch.Tensor,     # (B,) valid positions per row
) -> torch.Tensor:
    """Launch the paged-attention kernel (scores scaled by ``hd ** -0.5``);
    returns float32 (B, H, hd).  Positions at or beyond ``kv_len[b]`` (or
    ``NP * page_size``) are never read, except in a row with
    ``kv_len[b] <= 0``, which averages v over all ``NP * page_size``
    positions as the plain version does; a table entry outside ``[0, P)``
    is clamped into the pool."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got {dev}")
    _require(k_pages, "k_pages", (torch.float32, torch.bfloat16), dev)
    _require(v_pages, "v_pages", k_pages.dtype, dev)
    b, h, hd = q.shape
    n_pool, page_size, kv_heads, hd2 = k_pages.shape
    if hd2 != hd or tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}")
    if ptab.ndim != 2 or ptab.shape[0] != b:
        raise ValueError(f"ptab must be (B={b}, NP), got {tuple(ptab.shape)}")
    if h % kv_heads:
        raise ValueError(f"{h} query heads not divisible by {kv_heads} "
                         "KV heads")
    if h // kv_heads > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention takes <= {MAX_GROUP} query heads "
                         f"per KV head and hd <= {MAX_HEAD_DIM}")
    qf = q.to(torch.float32).contiguous()
    tab = ptab.to(device=dev, dtype=torch.int32).contiguous()
    lens = kv_len.to(device=dev, dtype=torch.int32).reshape(b).contiguous()
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _lib("flash_decode", _ENTRIES, _PAGED_ARGS)
    entry = _ENTRIES[0] if k_pages.dtype == torch.float32 else _ENTRIES[1]
    n_pages = tab.shape[1]
    scratch = decode_scratch(lib, b, n_pages * page_size, kv_heads,
                             h // kv_heads, hd, k_pages, page_size)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            _ptr(qf), _ptr(k_pages), _ptr(v_pages), _ptr(tab), _ptr(lens),
            _ptr(out), _ptr(scratch), b, n_pages, page_size, n_pool,
            h, kv_heads, hd, hd ** -0.5, _stream(dev))
    _check_launch(rc, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
