"""Shared layers: norms, RoPE, dense projections with the analog execution
hook, activations, and streaming attention (counterpart of
``repro.models.layers``).

Parameters stay in their float32 master copy; each use casts to the
compute dtype of the activations it meets (``cfg.dtype``), elementwise the
same as the reference's up-front ``cast_params``, without copying weight
matrices that the analog path never reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.analog import AnalogWeights, analog_matmul
from repro_torch.core.quant import calibrate_act_range, div_as_compiled
from repro_torch.hw.profile import SiteSpecs
from repro_torch.pytree import leaves

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AnalogCtx:
    """Per-layer analog execution context threaded through blocks.

    ``weights[name]`` is this layer's :class:`AnalogWeights`, ``lo/hi``
    the calibrated per-slice ADC limits, ``act`` the activation clips;
    ``specs`` the site-resolved spec per hook name (sites absent from
    ``weights`` run digitally).  ``collect=True`` bypasses the ADC and
    emits calibration statistics into the block's aux dict.
    """

    specs: SiteSpecs
    weights: Dict[str, AnalogWeights]
    lo: Dict[str, torch.Tensor]
    hi: Dict[str, torch.Tensor]
    act: Dict[str, torch.Tensor]
    collect: bool = False


def dense(x: torch.Tensor, w: torch.Tensor, name: str,
          ctx: Optional[AnalogCtx], aux: Optional[dict] = None, *,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` — digitally, or through the analog pipeline when ``ctx``
    carries programmed conductances for ``name``."""
    if ctx is None or name not in ctx.weights:
        y = x @ w.to(x.dtype)
    else:
        aw = ctx.weights[name]
        spec = ctx.specs.spec_for(name)
        if ctx.collect:
            y, stats = analog_matmul(x, aw, spec, act_hi=ctx.act.get(name),
                                     collect=True)
            if aux is not None:
                aux[f"adc/{name}"] = stats
                _, a_hi = calibrate_act_range(x, spec.input_bits)
                aux[f"act/{name}"] = a_hi
        else:
            y = analog_matmul(x, aw, spec, adc_lo=ctx.lo[name],
                              adc_hi=ctx.hi[name], act_hi=ctx.act.get(name))
        y = y.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; under ``remat``, while autograd records a gradient
    through ``args``, as one activation checkpoint (non-reentrant
    ``torch.utils.checkpoint``: the call's saved tensors are dropped and
    recomputed in the backward), the counterpart of the reference's
    ``jax.checkpoint`` of a layer's scan body.  The values are the same
    either way."""
    if remat and torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in leaves(args)):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    """Norm with its parameters cast to the activations' dtype first."""
    if kind == "layernorm":
        return layer_norm(x, p["scale"].to(x.dtype), p["bias"].to(x.dtype))
    return rms_norm(x, p["scale"].to(x.dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "swiglu": F.silu,
    "geglu": gelu,
    "gelu": gelu,
}


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding in the reference's roll form,
    ``x * cos + rotate_half(x) * sin``.  x: (B, S, H, hd); positions:
    (B, S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    idx = torch.arange(hd, device=x.device)
    # as the reference's jitted rope computes it (half need not be a
    # power of two: zamba2-7b's 112-wide heads give 56)
    freqs = theta ** div_as_compiled(-(idx % half).to(torch.float32),
                                     half)                          # (hd,)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs            # (B, S, hd)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    sign = torch.where(idx < half, -1.0, 1.0).to(torch.float32)
    rot = torch.roll(x, half, dims=-1) * sign                       # [-x2, x1]
    return (x * cos + rot * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# streaming attention (online softmax over KV chunks)
# ---------------------------------------------------------------------------


def streaming_attention(
    q: torch.Tensor,              # (B, Sq, H, hd)
    k: torch.Tensor,              # (B, Skv, KV, hd)
    v: torch.Tensor,              # (B, Skv, KV, hd)
    *,
    q_offset,                     # absolute position of q[0]: scalar or (B,)
    causal: bool = True,
    window=None,
    kv_len=None,                  # valid KV length: scalar or (B,)
    chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention with an online softmax over KV chunks (a Python loop
    in place of the reference's ``lax.scan``).  ``q_offset``/``kv_len``
    may be per-row ``(B,)`` tensors (continuous-batching decode)."""
    b, sq, h, hd = q.shape
    _, skv, kv_heads, _ = k.shape
    g = h // kv_heads
    scale = scale if scale is not None else hd ** -0.5
    dev = q.device

    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))

    qg = q.reshape(b, sq, kv_heads, g, hd).to(torch.float32) * scale
    # (sq,) for a shared scalar offset, (B, sq) for per-row offsets
    q_pos = torch.as_tensor(q_offset, device=dev)[..., None] \
        + torch.arange(sq, device=dev)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev)

    m = torch.full((b, kv_heads, g, sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kv_heads, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kv_heads, g, sq, hd), dtype=torch.float32,
                      device=dev)
    for j in range(n_chunks):
        k_j = k[:, j * chunk:(j + 1) * chunk].to(torch.float32)
        v_j = v[:, j * chunk:(j + 1) * chunk].to(torch.float32)
        k_pos = j * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, k_j)
        mask = torch.ones(q_pos.shape + (chunk,), dtype=torch.bool,
                          device=dev)                    # (..., sq, chunk)
        if causal:
            mask = mask & (k_pos <= q_pos[..., None])
        if window is not None:
            mask = mask & (k_pos > q_pos[..., None] - window)
        if kv_len is not None:
            mask = mask & (k_pos < kv_len[..., None, None])
        if pad:
            mask = mask & (k_pos < skv)
        mask = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, v_j)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]           # (b,k,g,q,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)
