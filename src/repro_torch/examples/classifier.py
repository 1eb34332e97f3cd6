"""The classifier the paper's accuracy claims are measured on: a small MLP
trained on a deterministic synthetic 64-class task (the port's copy of
``benchmarks/common.py``'s vehicle: ``make_dataset``, ``mlp_forward``,
``train_mlp``, ``eval_data`` and ``digital_accuracy``).

The paper's claims are about *trained* networks (zero-peaked weight
distributions are the mechanism behind proportional mapping).  The
draws come from ``torch.Generator`` with the reference's seeds in the
same roles (its ``jax.random`` keys become integer seeds), so the
dataset and the trained weights match the reference's in distribution,
not in value.  Trained weights are cached as
``build/examples/mlp_<seed>.npz``.
"""

from __future__ import annotations

import functools
import os
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.errors import fold_seed
from repro_torch.core.quant import (calibrate_act_range, quantize_acts,
                                    quantize_weights)
from repro_torch.examples import BUILD

N_CLASSES = 64
DIMS = (64, 256, 256, 256, N_CLASSES)

Layers = List[Tuple[torch.Tensor, torch.Tensor]]


def make_dataset(seed: int, n: int, *, device="cuda",
                 centers_seed: int = 42, warp_seed: int = 43):
    """Heavily-overlapping Gaussian clusters with class-dependent warps:
    hard enough that accuracy sits well below 100% and analog errors bite
    (the sensitivity regime the paper's Fig. 5 shows for ImageNet).  The
    class centers and warps, shared by every split, come from
    ``centers_seed`` and ``warp_seed``, the labels and the noise from
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, N_CLASSES, (n,), generator=gen)
    centers = torch.randn((N_CLASSES, DIMS[0]), generator=torch.Generator()
                          .manual_seed(centers_seed))
    x = centers[labels] * 0.9
    x = x + 1.2 * torch.randn((n, DIMS[0]), generator=gen)
    warp = torch.randn((N_CLASSES, DIMS[0]),
                       generator=torch.Generator().manual_seed(warp_seed))
    x = x + 0.5 * warp[labels] * torch.tanh(x)
    return x.to(device), labels.to(device)


def mlp_forward(params: Layers, x: torch.Tensor, *, act_fn=torch.relu):
    h = x
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < len(params) - 1:
            h = act_fn(h)
    return h


def train_mlp(seed: int = 0, steps: int = 1500, lr: float = 3e-3, *,
              device="cuda", cache_dir: str = BUILD) -> Layers:
    """The MLP trained by SGD on 8192 examples (seed 100), batches of 256
    drawn with replacement; read from ``cache_dir`` when it is there."""
    path = os.path.join(cache_dir, f"mlp_{seed}.npz")
    n = len(DIMS) - 1
    if os.path.exists(path):
        with np.load(path) as z:
            return [(torch.as_tensor(z[f"w{i}"], device=device),
                     torch.as_tensor(z[f"b{i}"], device=device))
                    for i in range(n)]
    gen = torch.Generator().manual_seed(seed)
    params = [
        ((torch.randn((DIMS[i], DIMS[i + 1]), generator=gen)
          * DIMS[i] ** -0.5).to(device),
         torch.zeros((DIMS[i + 1],), device=device))
        for i in range(n)
    ]
    xtr, ytr = make_dataset(100, 8192, device=device)

    def loss(p, x, y):
        logits = mlp_forward(p, x)
        return torch.mean(torch.logsumexp(logits, -1)
                          - torch.gather(logits, -1, y[:, None])[:, 0])

    for i in range(steps):
        idx = torch.randint(0, xtr.shape[0], (256,), generator=torch
                            .Generator().manual_seed(fold_seed(seed, i)))
        idx = idx.to(device)
        with torch.enable_grad():
            live = [(w.requires_grad_(True), b.requires_grad_(True))
                    for w, b in params]
            grads = torch.autograd.grad(
                loss(live, xtr[idx], ytr[idx]),
                [t for wb in live for t in wb])
        params = [(w.detach() - lr * gw, b.detach() - lr * gb)
                  for (w, b), gw, gb in zip(params, grads[0::2], grads[1::2])]
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(path, **{f"w{i}": w.cpu().numpy() for i, (w, b) in
                      enumerate(params)},
             **{f"b{i}": b.cpu().numpy() for i, (w, b) in enumerate(params)})
    return params


@functools.lru_cache(maxsize=2)
def eval_data(device="cuda"):
    """(calibration x, y, test x, y): 512 examples from seed 200 and 2048
    from seed 300."""
    xca, yca = make_dataset(200, 512, device=device)
    xte, yte = make_dataset(300, 2048, device=device)
    return xca, yca, xte, yte


def digital_accuracy(params: Layers, *, weight_bits: int = 8,
                     act_bits: int = 8) -> float:
    """8-bit quantized digital baseline (the paper's reference point): each
    layer's input clipped to the L1-optimal range of the calibration
    split's activations at that layer."""
    device = params[0][0].device
    xca, _, xte, yte = eval_data(str(device))
    h = xte
    for i, (w, b) in enumerate(params):
        qw = quantize_weights(w, weight_bits)
        _, hi = calibrate_act_range(_layer_inputs(params, xca, i), act_bits)
        qx = quantize_acts(h, act_bits, clip_hi=hi)
        h = qx.dequant() @ qw.dequant() + b
        if i < len(params) - 1:
            h = torch.relu(h)
    return float(torch.mean((torch.argmax(h, -1) == yte).float()))


def _layer_inputs(params: Layers, x: torch.Tensor, layer: int):
    h = x
    for i, (w, b) in enumerate(params):
        if i == layer:
            return h
        h = torch.relu(h @ w + b)
    return h
