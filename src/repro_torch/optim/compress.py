"""Error-feedback int8 gradient compression (counterpart of
``repro.optim.compress``, its local part).

The gradient plus the carried residual is quantized to int8 with one
float32 scale per leaf; the quantization error is carried to the next
step, which keeps SGD and Adam converging.  The reference's
``ring_allreduce_int8``, a ``shard_map`` ring over a named mesh axis,
belongs with scale-out (ROADMAP queue A item 12) and is not here.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.quant import true_div
from repro_torch.pytree import flatten_with_path, leaves, tree_map, unflatten_into


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = true_div(torch.clamp(x.abs().max(), min=1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(grads: Any, residual: Any) -> Tuple[Any, Any, Any]:
    """Quantize (grad + residual) to int8; return (q, scales,
    new_residual), each shaped like ``grads``."""

    def one(g, r):
        x = g.to(torch.float32) + r
        q, s = _quant_int8(x)
        return q, s, x - _dequant(q, s)

    out = {name: one(g, r) for (name, g), r in zip(flatten_with_path(grads),
                                                   leaves(residual))}
    return tuple(unflatten_into(grads, {n: o[i] for n, o in out.items()})
                 for i in range(3))


def init_residual(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
