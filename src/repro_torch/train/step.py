"""Training step: loss, microbatched gradient accumulation, clipping,
AdamW (counterpart of ``repro.train.step``).

``train_step_fn`` returns a plain function ``(state, batch) -> (state,
metrics)``.  Each microbatch is one forward and one
``torch.autograd.grad`` (the reference runs ``loss_fn`` and ``jax.grad``
apart; the values are the same).  Microbatch gradients are summed into
float32 zeros in microbatch order, then divided by the count, as the
reference's ``lax.scan`` does; remat inside the model (per-layer
activation checkpoints, ``models.layers.remat_call``) plus microbatching
is the memory lever for the large train cells.

One known departure, in bfloat16 configs only (every smoke config is
float32, so the CPU tests cannot see it): the reference casts the
float32 masters to the compute dtype once (``cast_params``), so the
cotangents of a weight used twice — the tied embedding and head, the
embedding rows of repeated tokens — are summed in bfloat16 before the
cast back.  The port casts at each use and sums them in float32.  On
CUDA the embedding gather's backward is an indexed scatter-add, so card
gates that compare gradients hold the embedding's within a bound.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant import true_div
from repro_torch.interop import params_from_numpy
from repro_torch.launch.op_stats import trips
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw
from repro_torch.pytree import (flatten_with_path, leaves, tree_map,
                                unflatten_into)
from repro_torch.sharding.perf import batch_rows, replicate_dims

MOE_LB_COEF = 0.01


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor        # int32, 0-d


def _state_of(params) -> TrainState:
    dev = leaves(params)[0].device
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def make_train_state(cfg: ModelConfig, seed: int = 0, *,
                     device="cuda") -> TrainState:
    """Fresh parameters from ``seed``, zero moments, step 0."""
    return _state_of(get_model(cfg).init_params(cfg, seed, device=device))


def train_state_from_numpy(params: Mapping, *, device="cuda") -> TrainState:
    """A fresh state around parameters given as a nested dict of numpy
    arrays (e.g. the reference's ``init_params``, exported)."""
    return _state_of(params_from_numpy(params, device=device))


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy.  On a mesh the gather of the targets' logits
    needs the vocab dim whole: vocab-sharded logits replicate it first
    (``sharding.perf.replicate_dims``; a plain tensor is untouched)."""
    logits = replicate_dims(logits, -1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    api = get_model(cfg)
    kw = {}
    if "prefix_embeds" in batch:
        kw["prefix_embeds"] = batch["prefix_embeds"]
    logits, aux = api.forward(cfg, params, batch["tokens"], **kw)
    loss = softmax_xent(logits, batch["targets"])
    if "moe/lb_loss" in aux:
        loss = loss + MOE_LB_COEF * torch.mean(aux["moe/lb_loss"])
    return loss, aux


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, aux, gradients shaped like ``params``) of one batch; a
    parameter the loss does not reach gets zeros, as under ``jax.grad``."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, aux = loss_fn(cfg, live, batch)
        named = flatten_with_path(live)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
    return loss.detach(), aux, unflatten_into(params, {
        name: torch.zeros_like(p) if g is None else g
        for (name, p), g in zip(named, grads)})


def train_step_fn(
    cfg: ModelConfig,
    *,
    microbatches: int = 1,
    lr_schedule: Optional[Callable] = None,
    max_grad_norm: float = 1.0,
    weight_decay: float = 0.1,
    lr: float = 3e-4,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, dict]]:
    """Build the train step for ``cfg`` (per-layer remat as ``cfg.remat``
    says)."""

    def split_micro(batch):
        out = []
        for name, x in batch.items():
            b = x.shape[0]
            if b % microbatches:
                raise ValueError(
                    f"batch dim {b} not divisible by {microbatches} "
                    f"microbatches")
            # microbatch i is rows [i * b / mb, (i + 1) * b / mb), as the
            # reference's; on a mesh each is laid out like the batch
            out.append((name, replicate_dims(x, 0).reshape(
                microbatches, b // microbatches, *x.shape[1:])))
        return [{name: batch_rows(x[i]) for name, x in out}
                for i in range(microbatches)]

    def step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        if microbatches == 1:
            loss, _, grads = loss_and_grads(cfg, state.params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(state.params)[0].device)
            for mb in trips(split_micro(batch)):
                l, _, g = loss_and_grads(cfg, state.params, mb)
                tree_map(lambda acc, x: acc.add_(x), grads, g)
                loss = loss + l
                # free them before the next microbatch's backward; each
                # microbatch then starts from the same live storage
                del l, _, g
            grads = tree_map(lambda g: true_div(g, microbatches), grads)
            loss = true_div(loss, microbatches)

        grads, gnorm = adamw.clip_by_global_norm(grads, max_grad_norm)
        lr_t = lr_schedule(state.step) if lr_schedule is not None else lr
        new_params, new_opt = adamw.update(
            grads, state.opt, state.params, lr=lr_t,
            weight_decay=weight_decay)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": torch.as_tensor(lr_t, dtype=torch.float32)}
        return (TrainState(params=new_params, opt=new_opt,
                           step=state.step + 1), metrics)

    return step
