"""AdamW written out (counterpart of ``repro.optim.adamw``; no
``torch.optim``): decoupled weight decay, bias-corrected moments,
global-norm clipping, the cosine schedule.

States are nested containers of tensors (``repro_torch.pytree``) shaped
like the parameters.  Moments are float32 whatever a parameter's dtype;
the update is applied as ``p + (-lr * u).to(p.dtype)``, the reference's
order.  Every division by a Python number goes through a tensor
(``core.quant.true_div``, or a 0-d tensor numerator), since PyTorch's CUDA
kernels multiply by the rounded reciprocal instead.  ``global_norm`` sums
the leaves' squares from 0 in ``jax.tree.leaves``' order (sorted keys).
``c1 = 1 - b1 ** t`` is ``torch.pow`` of a float32 tensor, which may sit
an ulp from XLA's ``pow``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.quant import true_div
from repro_torch.pytree import (flatten_with_path, leaves, tree_map,
                                unflatten_into)


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor        # int32, 0-d
    mu: Any
    nu: Any


def init(params) -> AdamWState:
    """Zero float32 moments and step 0, on the parameters' device."""
    z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=z, nu=tree_map(torch.clone, z))


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def _over(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as an IEEE division (``float / tensor`` in PyTorch is a
    reciprocal times ``num``)."""
    return torch.full((), num, dtype=t.dtype, device=t.device) / t


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(norm),
                          _over(max_norm, torch.clamp(norm, min=1e-9)))
    return tree_map(lambda g: g * scale, grads), norm


def update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Tuple[Any, AdamWState]:
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / c1
        vh = v / c2
        u = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
        return p + (-lr * u).to(p.dtype), m, v

    new = {name: upd(g, m, v, p) for (name, p), g, m, v in zip(
        flatten_with_path(params), leaves(grads), leaves(state.mu),
        leaves(state.nu))}
    p_new, mu, nu = (unflatten_into(params, {n: o[i] for n, o in new.items()})
                     for i in range(3))
    return p_new, AdamWState(step=step, mu=mu, nu=nu)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = true_div(base_lr * step, max(warmup, 1))
        frac = torch.clamp(true_div(step - warmup, max(total - warmup, 1)),
                           0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr
