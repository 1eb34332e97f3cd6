"""Feed-forward blocks (counterpart of ``repro.models.mlp``): the gated
(SwiGLU/GeGLU) and plain MLPs, and top-k token-choice Mixture-of-Experts
with capacity-based dispatch.

MoE dispatch builds no (tokens, experts, capacity) tensor: assignments are
flattened, positions within an expert come from a token-major cumsum over
``(tokens * k, E)`` one-hots, and tokens move into an ``(E * C, d)``
buffer.  Assignments past an expert's capacity are dropped and fall back
to the residual stream.  The experts stay digital, as in the reference
(DESIGN.md, MoE-expert caveat).  The reference's three mesh-sharding
branches (``sharding.perf.FLAGS``: ``moe_dispatch_sharding``,
``moe_cap_shard``, ``moe_weight_gather``) constrain the dispatch buffer,
the expert outputs and the expert weights to a layout on the mesh
(``sharding.perf.constraint``); they move data and change no value, and
on plain tensors they do nothing.  On a mesh the routing's buffers are
made like the token rows (``new_zeros``), so they are DTensors too, and
the load fraction counts one-hots (``F.one_hot(...).sum``, equal to a
``bincount``, which DTensor has no strategy for).

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
from repro_torch.sharding.perf import (FLAGS, batch_rows, constraint,
                                      contract_like, grad_layout, grad_rows,
                                      layout_like, local_gather, operand_like,
                                      partial_to_shard, product_rows,
                                      replicate_dims, rows_to_columns)


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
    gates = torch.softmax(grad_rows(xt.to(torch.float32)
                                    @ router.to(torch.float32)), dim=-1)
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
    dtype.  On a mesh the rows' experts and d are first split as
    ``w_gate``'s (and ``w_up``'s) are, so each rank multiplies its own
    slice, and the partial sums of a split d are reduced into shards of
    the capacity: the layout the two torch versions' planners otherwise
    choose differently (the card's replicated the capacity over
    ``data``, and each of its ranks repeated the experts' work)."""
    fn = ACTIVATIONS[act]
    dt = xe.dtype
    xe = operand_like(xe, p["w_gate"], (2, 1), (0, 0))

    def product(w):
        return partial_to_shard(
            torch.einsum("ecd,edf->ecf", xe, w.to(dt)), 1)

    g = fn(product(p["w_gate"]))
    h = g * product(p["w_up"])
    # on a mesh, f split as w_down's is, so each rank multiplies its slice
    h = contract_like(h, p["w_down"], 2, 1)
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
    # the token rows by the batch rule (a sequence sharded over "model"
    # would flatten into a strided shard), and their gradient, summed from
    # the router and the dispatch, laid out as the rows before the view
    # back to (B, S, d), which cannot unflatten rows split over every dim
    xt = grad_layout(product_rows(x).reshape(t, d))
    gates, topw, topi = _route(xt, p["router"], k)

    # load-balance loss (Switch-style): E * sum_e f_e * p_e
    me = gates.mean(dim=0)
    ce = div_as_compiled(
        F.one_hot(topi.reshape(-1), e).sum(dim=0).to(torch.float32), t * k)
    lb_loss = e * (me * ce).sum()

    cap = moe_capacity(t, cfg)
    keep, dest = _dispatch(topi, e, cap)
    wgt = topw.reshape(-1).to(x.dtype)
    tok = torch.arange(t, device=dev).repeat_interleave(k)

    # every kept assignment owns its buffer row, so a plain write moves
    # it; the dropped ones all land on the overflow row, which is cut off.
    # On a mesh the write is out of place on whole operands, the layout
    # the in-place write took: the card's torch has no DTensor strategy
    # for an in-place ``index_put_``.  The token rows are gathered whole
    # and each rank picks its assignments' rows itself (``local_gather``):
    # no index op of a sharded DTensor, whose backward the card's torch
    # plans on rows past a shard
    xbuf = replicate_dims(xt.new_zeros((e * cap + 1, d)), 0, 1).index_put(
        (replicate_dims(dest, 0),),
        local_gather(replicate_dims(xt, 0, 1), tok))
    # its gradient arrives laid out like the experts' outputs (on a mesh,
    # experts and capacity both sharded), which the flattened rows' view
    # would turn into a strided shard: it is laid out as the buffer first
    xe = grad_layout(xbuf[:e * cap].reshape(e, cap, d))

    if FLAGS.moe_dispatch_sharding:
        # the dispatched buffer on the expert-parallel layout, so the
        # scatter becomes an exchange instead of replicate + all-reduce
        # (the reference's hypothesis M1)
        xe = constraint(xe, "model", None, None)
    if FLAGS.moe_cap_shard:
        # 2D expert parallelism: experts over "model", capacity over
        # "data" (M4); a mesh without "data" leaves the buffer as it is
        xe = constraint(xe, "model", "data", None)
    if FLAGS.moe_weight_gather:
        # gather the expert weights before use instead of all-reducing
        # the f-dim partial sums of the activations (M3)
        p = dict(p)
        for wname in ("w_gate", "w_up", "w_down"):
            p[wname] = constraint(p[wname], "model", None, None)

    ye = _experts(p, xe, cfg.act)
    if FLAGS.moe_dispatch_sharding:
        ye = constraint(ye, "model", None, None)
    if FLAGS.moe_cap_shard:
        ye = constraint(ye, "model", "data", None)

    # ---- combine: a token's k slots summed in ascending order ----------
    # capacity whole before it flattens with the experts (a shard of it
    # inside the flattened rows would be a strided shard); on a mesh the
    # experts' rows are then exchanged for columns (one all-to-all), and
    # each rank gathers its own tokens' rows of its columns
    yflat = rows_to_columns(replicate_dims(ye, 1).reshape(e * cap, d))
    contrib = torch.where(keep, wgt, torch.zeros_like(wgt))[:, None] \
        * local_gather(yflat, batch_rows(torch.clamp(dest, max=e * cap - 1)))
    contrib = contrib.reshape(t, k, d)
    y = xt.new_zeros((t, d))
    for j in range(k):
        y = y + contrib[:, j]
    # on a mesh, laid out as the token rows came in
    y = layout_like(y, xt)

    if aux is not None:
        aux["moe/lb_loss"] = lb_loss
        aux["moe/drop_frac"] = 1.0 - keep.to(torch.float32).mean()
    # the gradient arrives sharded like the stream after the block (on a
    # mesh, S over "model"), which the token rows' view would turn into a
    # strided shard: it is laid out as the output first
    return grad_layout(y.reshape(b, s, d)), lb_loss


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
