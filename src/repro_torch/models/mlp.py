"""Feed-forward blocks (counterpart of ``repro.models.mlp``): the gated
(SwiGLU/GeGLU) and plain MLPs.  Mixture-of-Experts waits for ROADMAP
queue A item 10."""

from __future__ import annotations

from typing import Optional

import torch

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
