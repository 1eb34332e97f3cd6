"""The sharded train, prefill and decode steps, and the meta-tensor input
specs of every (arch x shape) cell (counterpart of
``repro.launch.steps``).

Each ``build_*`` returns ``(fn, structs)``.  ``structs`` are trees of
meta tensors (the port's ``jax.eval_shape`` structs; no memory behind
them).  ``fn`` takes the state or parameters and the batch, places every
leaf on the mesh by ``sharding.rules`` (a plain tensor is distributed, a
DTensor redistributed where it differs: the reference's
``in_shardings``), runs the port's own ``train_step_fn``, ``prefill`` or
``decode_step`` on the DTensors under ``implicit_replication()`` (plain
tensors made inside the step, such as positions and masks, count as
replicated), and returns its outputs placed as the reference's
``out_shardings``: state like its input, metrics replicated, logits and
caches by the batch and cache rules.  The reference donates the decode
cache (``donate_argnums``); here the decode step writes it in place.

DTensor runs every op of these steps on sharded operands, with its own
redistributions, except where the model code acts explicitly, as GSPMD
inserts its collectives:

* ``models.layers.streaming_attention`` — each rank attends its own rows
  and KV heads, or, on a sequence-sharded cache, its own positions,
  the blocks folded by all-reduces of the online softmax's state
  (``sharding.perf.local_attention``): attention is independent per
  (row, head), and DTensor's propagation of its batched products over a
  batch and a head dim both sharded costs seconds per new shape;
* ``models.layers.dense`` — the product's rows are laid out by the
  batch rule on both sides (``sharding.perf.product_rows``): DTensor's
  cost model counts communication only, and left every row on every
  rank, the product replicated over ``model``; heads are split only
  where the mesh divides them (``sharding.perf.split_heads``);
* ``models.transformer._embed``, ``models.hybrid._embed`` and
  ``models.encdec._embed`` — each rank looks up its own shard of the
  table (``sharding.perf.local_embedding``), and the rows come out laid
  out as the batch (``batch_rows``): the card's torch has no DTensor
  plan for an indexed table's backward;
* ``models.layers.norm`` — a layer norm's d is made whole first
  (``replicate_dims``), and each rank normalizes its own rows;
* ``models.ssm.mamba_block`` — each rank convolves its own rows and
  channels (``sharding.perf.local_channels``), and the out-norm's
  gradient keeps its input's layout (``grad_layout``);
* ``train.step`` — the gather of the targets' logits replicates the
  vocab dim of vocab-sharded logits first
  (``sharding.perf.replicate_dims``), and each microbatch is laid out
  like the batch (``sharding.perf.batch_rows``);
* ``models.attention._write_cache`` — an index write cannot keep a
  sharded cache's placements, so each rank writes its own shard
  (``sharding.perf.write_local``), and a cache made inside the step
  (the hybrid's prefill) takes the new K/V replicated;
* ``models.mlp.moe_block`` — the load fraction counts one-hots
  (``bincount`` has no sharding strategy), and the dispatch buffers are
  made like the token rows (``new_zeros``), so they are DTensors too;
  the dispatch and the combine gather rows on each rank
  (``sharding.perf.local_gather``: no index op of a sharded DTensor),
  the experts' operands are split as their weights
  (``operand_like``, ``partial_to_shard``), the combine reads the
  experts' columns (``rows_to_columns``, one all-to-all) and its output
  is laid out as the token rows came in (``layout_like``), and the
  router's gradient is split by rows over the whole mesh
  (``grad_rows``);
* ``models.layers.rope`` spells its roll as a concat of halves (``roll``
  has no strategy on the card's torch), and ``models.layers.dense`` its
  product as one 2-D ``mm`` (``matmul`` would pick ``bmm`` from a
  DTensor's strides at a size-1 dim): both the same values as before.

On one rank every one of these is the plain path's arithmetic; across
ranks the fold of attention's position blocks, and the gradients of the
embedding (dense, hybrid and encoder-decoder families alike) and of the
MoE gathers, sum in another order.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.registry import get_model
from repro_torch.pytree import tree_map
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P
from repro_torch.train.step import make_train_state, train_step_fn

META = "meta"


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if shape.kind != "train":
        return 1
    big = cfg.param_count() > 2e10
    return 8 if big else 4


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Meta-tensor stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=META)
    if shape.kind in ("train", "prefill"):
        spec = {"tokens": torch.empty((b, s), **i32)}
        if shape.kind == "train":
            spec["targets"] = torch.empty((b, s), **i32)
        if cfg.frontend:
            spec["prefix_embeds"] = torch.empty(
                (b, cfg.n_frontend_tokens, cfg.d_model), dtype=torch.float32,
                device=META)
        return spec
    # decode: one new token against a seq_len cache
    cache = get_model(cfg).init_cache(cfg, b, s, device=META)
    return {"token": torch.empty((b, 1), **i32), "cache": cache}


def input_shardings(cfg: ModelConfig, mesh, kind: str, structs) -> tuple:
    """The rules' specs of a step's two inputs, ``(state or params,
    batch)`` (the reference's ``in_shardings``): the optimizer state's
    (train) or the parameters' with FSDP, and the batch's; a decode
    batch's cache by the cache rule."""
    first, batch = structs
    if kind == "train":
        first_sh = rules.opt_state_shardings(cfg, first, mesh, fsdp=True)
    else:
        first_sh = rules.tree_param_shardings(cfg, first, mesh, fsdp=True)
    if kind == "decode":
        batch_sh = {
            "token": rules.batch_spec(tuple(batch["token"].shape), mesh),
            "cache": rules.tree_cache_shardings(cfg, batch["cache"], mesh),
        }
    else:
        batch_sh = rules.tree_batch_shardings(batch, mesh)
    return first_sh, batch_sh


def _kw(batch) -> dict:
    return ({"prefix_embeds": batch["prefix_embeds"]}
            if "prefix_embeds" in batch else {})


def _made_here(tree, mesh):
    """``tree`` with each plain tensor (made inside the step from Python
    numbers, the same on every rank: ``implicit_replication``'s reading)
    replicated where it is, as the reference's every device computes it;
    distributing it would broadcast rank 0's copy."""
    return tree_map(lambda x: x if isinstance(x, DTensor) else
                    DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False), tree)


def _place_out(x, mesh):
    """An output tensor (logits) placed by the batch rule."""
    return rules.distribute_tree(x, rules.batch_spec(tuple(x.shape), mesh),
                                 mesh)


# ---------------------------------------------------------------------------


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     *, microbatches: Optional[int] = None, **step_kw):
    """Returns ``(fn, (state_struct, batch_struct))``; ``fn(state, batch)
    -> (state, metrics)``.  ``step_kw`` go to ``train_step_fn``."""
    mb = default_microbatches(cfg, shape) if microbatches is None \
        else microbatches
    step = train_step_fn(cfg, microbatches=mb, **step_kw)
    state_struct = make_train_state(cfg, 0, device=META)
    batch_struct = input_specs(cfg, shape)

    state_sh, batch_sh = input_shardings(cfg, mesh, shape.kind,
                                         (state_struct, batch_struct))
    metric_sh = {"loss": P(), "grad_norm": P(), "lr": P()}

    def fn(state, batch):
        state = rules.distribute_tree(state, state_sh, mesh)
        batch = rules.distribute_tree(batch, batch_sh, mesh)
        with implicit_replication():
            state, metrics = step(state, batch)
        return (rules.distribute_tree(state, state_sh, mesh),
                rules.distribute_tree(_made_here(metrics, mesh), metric_sh,
                                      mesh))

    return fn, (state_struct, batch_struct)


def build_prefill(cfg: ModelConfig, mesh, shape: ShapeConfig):
    """Returns ``(fn, (params_struct, batch_struct))``; ``fn(params,
    batch) -> (last-token logits, cache)``."""
    api = get_model(cfg)
    params_struct = api.init_params(cfg, 0, device=META)
    batch_struct = input_specs(cfg, shape)
    max_len = shape.seq_len
    params_sh, batch_sh = input_shardings(cfg, mesh, shape.kind,
                                          (params_struct, batch_struct))

    def fn(params, batch):
        params = rules.distribute_tree(params, params_sh, mesh)
        batch = rules.distribute_tree(batch, batch_sh, mesh)
        with implicit_replication():
            logits, cache = api.prefill(cfg, params, batch["tokens"],
                                        max_len, **_kw(batch))
        cache = _made_here(cache, mesh)
        return (_place_out(logits, mesh), rules.distribute_tree(
            cache, rules.tree_cache_shardings(cfg, cache, mesh), mesh))

    return fn, (params_struct, batch_struct)


def build_decode(cfg: ModelConfig, mesh, shape: ShapeConfig):
    """Returns ``(fn, (params_struct, batch_struct))``; ``fn(params,
    batch) -> (logits, cache)``, ``batch`` ``{"token", "cache"}`` (the
    cache is written in place)."""
    api = get_model(cfg)
    params_struct = api.init_params(cfg, 0, device=META)
    batch_struct = input_specs(cfg, shape)
    params_sh, batch_sh = input_shardings(cfg, mesh, shape.kind,
                                          (params_struct, batch_struct))

    def fn(params, batch):
        params = rules.distribute_tree(params, params_sh, mesh)
        batch = rules.distribute_tree(batch, batch_sh, mesh)
        with implicit_replication():
            logits, cache = api.decode_step(cfg, params, batch["token"],
                                            batch["cache"])
        cache = _made_here(cache, mesh)
        return (_place_out(logits, mesh), rules.distribute_tree(
            cache, rules.tree_cache_shardings(cfg, cache, mesh), mesh))

    return fn, (params_struct, batch_struct)


def build_step(cfg: ModelConfig, mesh, shape: ShapeConfig, **kw):
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill(cfg, mesh, shape)
    return build_decode(cfg, mesh, shape)
