"""Mamba2 and RWKV6 blocks on the shared chunked decay recurrence
(counterpart of ``repro.models.ssm``).

* Mamba2: in/out projections, depthwise causal conv, per-head scalar decay
  ``exp(-softplus(dt) * A_h)``, the SSD recurrence, D skip, SiLU-gated
  output, RMS norm before the out-projection.
* RWKV6 "Finch": token shift with a learned static mix, r/k/v/g
  projections, data-dependent decay from a low-rank MLP on the shifted
  stream, current-token bonus ``u``, per-head group norm, SiLU gate.

The analog hook applies to the weight-stationary projections only (hook
names ``ssm_in``/``ssm_out``, ``rwkv_wr`` ... ``rwkv_cr``); the LoRA
matmuls and the state recurrences stay digital, as in the reference.

Parameters are float32 masters cast at each use to the activations' dtype,
except ``a_log``, ``dt_bias``, ``d_skip``, ``w_base`` and ``u``, which the
reference keeps in float32 whatever the dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import AnalogCtx, dense, rms_norm
from repro_torch.models.recurrent import chunked_decay_recurrence, decay_step
from repro_torch.sharding.perf import (grad_layout, local_recurrence,
                                      local_channels, split_heads)

CONV_W = 4  # depthwise conv window


def _normal(gen: torch.Generator, device, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` takes it (``logaddexp``
    with 0, no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    return cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
               device) -> dict:
    d = cfg.d_model
    h, hd, st = mamba_dims(cfg)
    din = h * hd
    proj_out = 2 * din + 2 * st + h          # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _normal(gen, device, n_layers, d, proj_out) * d ** -0.5,
        "conv_w": _normal(gen, device, n_layers, CONV_W, din + 2 * st) * 0.3,
        "a_log": torch.zeros((n_layers, h), **f32),
        "dt_bias": torch.zeros((n_layers, h), **f32),
        "d_skip": torch.ones((n_layers, h), **f32),
        "out_norm": torch.zeros((n_layers, din), **f32),
        "out_proj": _normal(gen, device, n_layers, din, d) * din ** -0.5,
    }


def _conv_window(x: torch.Tensor, carry: Optional[torch.Tensor] = None):
    """The depthwise causal conv's input window: ``carry`` (B, W-1, C;
    zeros when None) followed by x (B, S, C)."""
    b, s, c = x.shape
    if carry is None:
        carry = torch.zeros((b, CONV_W - 1, c), dtype=x.dtype,
                            device=x.device)
    return torch.cat([carry, x], dim=1)


def _causal_conv(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the window ``xp`` (B, W-1+S, C); w: (W,
    C) in xp's dtype.  Returns silu(out) (B, S, C)."""
    s = xp.shape[1] - (CONV_W - 1)
    out = xp[:, 0:s] * w[0][None, None]
    for i in range(1, CONV_W):
        out = out + xp[:, i:i + s] * w[i][None, None]
    return F.silu(out)


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[dict] = None, decode: bool = False,
                ctx: Optional[AnalogCtx] = None,
                aux: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d); ``state`` {"ssm": (B, H, st, hd), "conv": (B, W-1,
    C)}.  Returns (out, new state)."""
    b, s, _ = x.shape
    h, hd, st = mamba_dims(cfg)
    din = h * hd
    f32 = torch.float32

    zxbcdt = dense(x, p["in_proj"], "ssm_in", ctx, aux)
    z, xs, bc, dt = torch.split(zxbcdt, [din, din, 2 * st, h], dim=-1)
    xp = _conv_window(torch.cat([xs, bc], dim=-1),
                      None if state is None else state["conv"])
    # on a mesh each rank convolves its own rows and channels
    conv_out = local_channels(_causal_conv, xp, p["conv_w"].to(x.dtype))
    conv_carry = xp[:, -(CONV_W - 1):]
    xs = conv_out[..., :din].reshape(b, s, h, hd)
    bmat = conv_out[..., din:din + st]                   # (B, S, st)
    cmat = conv_out[..., din + st:]                      # (B, S, st)

    a = -torch.exp(p["a_log"].to(f32))                   # (H,) negative
    dt_sp = _softplus(dt.to(f32) + p["dt_bias"].to(f32))  # (B, S, H)
    log_w = (dt_sp * a[None, None])[..., None].expand(b, s, h, st)

    # k = dt-scaled B (shared across heads), v = x, r = C
    k = bmat[:, :, None, :].expand(b, s, h, st) * dt_sp[..., None]
    r = cmat[:, :, None, :].expand(b, s, h, st)
    v = xs

    s0 = None if state is None else state["ssm"]
    if decode:
        if s0 is None:
            s0 = torch.zeros((b, h, st, hd), dtype=f32, device=x.device)
        y1, new_ssm = local_recurrence(decay_step, r[:, 0], k[:, 0], v[:, 0],
                                       log_w[:, 0], s0)
        y = y1[:, None]
    else:
        y, new_ssm = local_recurrence(chunked_decay_recurrence, r, k, v,
                                      log_w, s0, chunk=64)

    y = y + xs * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, din) * F.silu(z)
    # on a mesh, the norm's gradient kept split as its input and output
    # are (the torch versions' planners otherwise split the sequence or
    # the channels in its backward)
    y = grad_layout(rms_norm(grad_layout(y), p["out_norm"].to(y.dtype)))
    out = dense(y, p["out_proj"], "ssm_out", ctx, aux)
    return out, {"ssm": new_ssm, "conv": conv_carry}


def mamba_state_init(cfg: ModelConfig, b: int, dtype, *,
                     device="cuda") -> dict:
    h, hd, st = mamba_dims(cfg)
    din = h * hd
    return {
        "ssm": torch.zeros((b, h, st, hd), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((b, CONV_W - 1, din + 2 * st), dtype=dtype,
                            device=device),
    }


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------

RWKV_LORA = 64


def init_rwkv(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
              device) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    sc = d ** -0.5
    l = n_layers
    f32 = dict(dtype=torch.float32, device=device)

    def normal(*shape):
        return _normal(gen, device, *shape)

    return {
        # time mix
        "mix": 0.5 * torch.ones((l, 5, d), **f32),      # r, k, v, g, w mixes
        "wr": normal(l, d, d) * sc,
        "wk": normal(l, d, d) * sc,
        "wv": normal(l, d, d) * sc,
        "wg": normal(l, d, d) * sc,
        "wo": normal(l, d, d) * sc,
        "w_base": -6.0 * torch.ones((l, d), **f32),
        "w_lora_a": normal(l, d, RWKV_LORA) * sc,
        "w_lora_b": normal(l, RWKV_LORA, d) * RWKV_LORA ** -0.5,
        "u": normal(l, h, hd) * 0.3,
        "ln_x_scale": torch.ones((l, d), **f32),
        "ln_x_bias": torch.zeros((l, d), **f32),
        # channel mix
        "cmix": 0.5 * torch.ones((l, 2, d), **f32),
        "ck": normal(l, d, cfg.d_ff) * sc,
        "cv": normal(l, cfg.d_ff, d) * cfg.d_ff ** -0.5,
        "cr": normal(l, d, d) * sc,
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """The x_{t-1} stream and the last token; ``prev`` (B, 1, d) is the
    last token carried from before ``x``."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1), x[:, -1:]


def rwkv_time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[dict], decode: bool,
                  ctx: Optional[AnalogCtx] = None,
                  aux: Optional[dict] = None):
    """Returns (out, {"wkv", "shift_t"}); ``shift_t`` is the last token of
    ``x`` (the norm1 output)."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    dt = x.dtype
    f32 = torch.float32
    xs, last = _token_shift(x, None if state is None else state["shift_t"])
    mixes = p["mix"].to(dt)

    def mix(i):
        m = mixes[i][None, None]
        return x * m + xs * (1.0 - m)

    r = split_heads(dense(mix(0), p["wr"], "rwkv_wr", ctx, aux), h)
    k = split_heads(dense(mix(1), p["wk"], "rwkv_wk", ctx, aux), h)
    v = split_heads(dense(mix(2), p["wv"], "rwkv_wv", ctx, aux), h)
    g = dense(mix(3), p["wg"], "rwkv_wg", ctx, aux)

    # Finch: data-dependent decay from a low-rank MLP on the mixed stream
    # (digital), clipped to [-8, 2] in float32 before the exp
    lora = dense(torch.tanh(dense(mix(4), p["w_lora_a"], "rwkv_lora_a",
                                  None)), p["w_lora_b"], "rwkv_lora_b", None)
    log_w = -torch.exp(torch.clamp(
        p["w_base"][None, None].to(f32) + lora.to(f32), -8.0, 2.0))
    log_w = split_heads(log_w, h)

    s0 = None if state is None else state["wkv"]
    if decode:
        if s0 is None:
            s0 = torch.zeros((b, h, hd, hd), dtype=f32, device=x.device)
        y1, new_wkv = local_recurrence(decay_step, r[:, 0], k[:, 0], v[:, 0],
                                       log_w[:, 0], s0, u=p["u"])
        y = y1[:, None]
    else:
        y, new_wkv = local_recurrence(chunked_decay_recurrence, r, k, v,
                                      log_w, s0, u=p["u"], chunk=32)

    # per-head group norm in float32 on y as the recurrence returned it
    # (r's dtype), eps 64e-5
    yh = y.reshape(b, s, h, hd).to(f32)
    mu = yh.mean(dim=-1, keepdim=True)
    var = ((yh - mu) ** 2).mean(dim=-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    # on a mesh the heads' gradient arrives with d split like the gate's,
    # which the view back to heads cannot unflatten where the mesh does
    # not divide them: it is laid out as the merged heads first
    y = grad_layout(yh.reshape(b, s, d)).to(dt) * p["ln_x_scale"].to(dt) \
        + p["ln_x_bias"].to(dt)
    y = y * F.silu(g)
    out = dense(y, p["wo"], "rwkv_wo", ctx, aux)
    return out, {"wkv": new_wkv, "shift_t": last}


def rwkv_channel_mix(p: dict, x: torch.Tensor, *, state: Optional[dict],
                     decode: bool, ctx: Optional[AnalogCtx] = None,
                     aux: Optional[dict] = None):
    """Returns (out, {"shift_c"}); ``shift_c`` is the last token of ``x``
    (the norm2 output)."""
    del decode   # the shift state alone carries a decode step
    xs, last = _token_shift(x, None if state is None else state["shift_c"])
    cmix = p["cmix"].to(x.dtype)
    mk, mr = cmix[0][None, None], cmix[1][None, None]
    xk = x * mk + xs * (1.0 - mk)
    xr = x * mr + xs * (1.0 - mr)
    kk = torch.square(F.relu(dense(xk, p["ck"], "rwkv_ck", ctx, aux)))
    rr = torch.sigmoid(dense(xr, p["cr"], "rwkv_cr", ctx, aux))
    out = rr * dense(kk, p["cv"], "rwkv_cv", ctx, aux)
    return out, {"shift_c": last}


def rwkv_state_init(cfg: ModelConfig, b: int, dtype, *,
                    device="cuda") -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    return {
        "wkv": torch.zeros((b, h, hd, hd), dtype=torch.float32,
                           device=device),
        "shift_t": torch.zeros((b, 1, d), dtype=dtype, device=device),
        "shift_c": torch.zeros((b, 1, d), dtype=dtype, device=device),
    }
