"""Feed-forward blocks (counterpart of ``repro.models.mlp``): the gated
(SwiGLU/GeGLU) and plain MLPs, and top-k token-choice Mixture-of-Experts
with capacity-based dispatch.

MoE dispatch builds no (tokens, experts, capacity) tensor: assignments are
flattened, positions within an expert come from a token-major cumsum over
``(tokens * k, E)`` one-hots, and tokens move into an ``(E * C, d)``
buffer.  Assignments past an expert's capacity are dropped and fall back
to the residual stream.  The experts stay digital, as in the reference
(DESIGN.md, MoE-expert caveat).  The reference's mesh-sharding branches
(``repro.sharding.perf.FLAGS``) are not ported: scale-out is ROADMAP
queue A item 12.

Two orders are fixed so that a run's bits do not depend on the device's
scheduling: top-k breaks ties to the lower expert index (as
``lax.top_k``), and a token's k contributions are summed in ascending
slot order (the reference's scatter-add order; ``index_add_`` on the card
adds with float atomics in no fixed order).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.quant import div_as_compiled
from repro_torch.models.layers import ACTIVATIONS, AnalogCtx, dense


def init_mlp(gen: torch.Generator, d: int, ff: int, act: str, n_layers: int,
             device) -> dict:
    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    sc_in, sc_out = d ** -0.5, ff ** -0.5
    p = {
        "w_up": normal(n_layers, d, ff) * sc_in,
        "w_down": normal(n_layers, ff, d) * sc_out,
    }
    if act in ("swiglu", "geglu"):
        p["w_gate"] = normal(n_layers, d, ff) * sc_in
    return p


def mlp_block(p: dict, x: torch.Tensor, act: str,
              ctx: Optional[AnalogCtx] = None,
              aux: Optional[dict] = None) -> torch.Tensor:
    fn = ACTIVATIONS[act]
    if "w_gate" in p:
        g = fn(dense(x, p["w_gate"], "w_gate", ctx, aux))
        h = g * dense(x, p["w_up"], "w_up", ctx, aux)
    else:
        h = fn(dense(x, p["w_up"], "w_up", ctx, aux))
    return dense(h, p["w_down"], "w_down", ctx, aux)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
             device) -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    sc_in, sc_out = d ** -0.5, ff ** -0.5
    return {
        "router": normal(n_layers, d, e) * sc_in,
        "w_gate": normal(n_layers, e, d, ff) * sc_in,
        "w_up": normal(n_layers, e, d, ff) * sc_in,
        "w_down": normal(n_layers, e, ff, d) * sc_out,
    }


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """Float32 softmax gates (T, E) and the renormalized top-k (weights,
    expert ids), ties to the lower expert index."""
    gates = torch.softmax(xt.to(torch.float32) @ router.to(torch.float32),
                          dim=-1)
    order = torch.sort(gates, dim=-1, descending=True, stable=True).indices
    topi = order[:, :k]
    topw = torch.gather(gates, 1, topi)
    return gates, topw / topw.sum(dim=-1, keepdim=True), topi


def _dispatch(topi: torch.Tensor, e: int, cap: int):
    """(keep, dest) of the flattened (token, slot) assignments, token-major:
    an assignment's position within its expert is the count of earlier
    assignments to it; those at or past ``cap`` are dropped, and ``dest``
    is ``expert * cap + position`` (``e * cap``, the overflow row, when
    dropped)."""
    eid = topi.reshape(-1)                                    # (T*k,)
    onehot = F.one_hot(eid, e)                                # (T*k, E)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    keep = pos < cap
    return keep, torch.where(keep, eid * cap + pos,
                             torch.full_like(pos, e * cap))


def _experts(p: dict, xe: torch.Tensor, act: str) -> torch.Tensor:
    """The experts' gated MLP on (E, C, d) rows, weights cast to the rows'
    dtype."""
    fn = ACTIVATIONS[act]
    dt = xe.dtype
    g = fn(torch.einsum("ecd,edf->ecf", xe, p["w_gate"].to(dt)))
    h = g * torch.einsum("ecd,edf->ecf", xe, p["w_up"].to(dt))
    return torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[AnalogCtx] = None,
              aux: Optional[dict] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d).  Returns (output, load-balance aux loss); ``aux``
    gets ``moe/lb_loss`` and ``moe/drop_frac``."""
    del ctx   # experts stay digital
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)
    gates, topw, topi = _route(xt, p["router"], k)

    # load-balance loss (Switch-style): E * sum_e f_e * p_e
    me = gates.mean(dim=0)
    ce = div_as_compiled(
        torch.bincount(topi.reshape(-1), minlength=e).to(torch.float32),
        t * k)
    lb_loss = e * (me * ce).sum()

    cap = moe_capacity(t, cfg)
    keep, dest = _dispatch(topi, e, cap)
    wgt = topw.reshape(-1).to(x.dtype)
    tok = torch.arange(t, device=dev).repeat_interleave(k)

    # every kept assignment owns its buffer row, so a plain write moves
    # it; the dropped ones all land on the overflow row, which is cut off
    xbuf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    xbuf[dest] = xt[tok]
    ye = _experts(p, xbuf[:e * cap].reshape(e, cap, d), cfg.act)

    # ---- combine: a token's k slots summed in ascending order ----------
    yflat = ye.reshape(e * cap, d)
    contrib = torch.where(keep, wgt, torch.zeros_like(wgt))[:, None] \
        * yflat[torch.clamp(dest, max=e * cap - 1)]
    contrib = contrib.reshape(t, k, d)
    y = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + contrib[:, j]

    if aux is not None:
        aux["moe/lb_loss"] = lb_loss
        aux["moe/drop_frac"] = 1.0 - keep.to(torch.float32).mean()
    return y.reshape(b, s, d), lb_loss


def moe_block_dense_ref(p: dict, x: torch.Tensor, cfg: ModelConfig
                        ) -> torch.Tensor:
    """O(E) plain version for tests: every expert computes every token,
    outputs weighted by the renormalized top-k gates."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    gates, topw, topi = _route(xt, p["router"], cfg.top_k)
    wfull = torch.zeros_like(gates).scatter(1, topi, topw)
    ye = _experts(p, xt[None].expand(cfg.n_experts, -1, -1), cfg.act)
    y = torch.einsum("te,etd->td", wfull.to(x.dtype), ye)
    return y.reshape(b, s, d)
