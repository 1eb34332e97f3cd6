"""Logical-axis sharding rules, pytree-path driven (counterpart of
``repro.sharding.rules``).

Every parameter, optimizer, cache and batch leaf is given a spec by
classifying its dims from its path in the tree (``pytree.
flatten_with_path``'s ``"a/b/c"`` names).  The mesh axes:

* ``model`` — tensor parallel: heads / ff / vocab / experts dims.
* ``data`` (+ ``pod``) — batch (activations), and FSDP/ZeRO sharding of
  the d_model dim of weights and optimizer moments.

Divisibility is checked per dim; a dim that does not divide falls back
to replication (e.g. zamba's 56 ssm heads over 16 model shards).
Flattened head dims (H * hd) shard on ``model`` even when H < n_model.

A spec is a :class:`P`, the port's ``PartitionSpec``: one entry per
tensor dim, an axis name, a tuple of names (one dim over several mesh
axes, major to minor) or ``None``.  The rules read only a mesh's names
and sizes (``launch.mesh.MeshShape``), so they run without devices;
:func:`to_placements` turns a spec into DTensor placements on a
``DeviceMesh``, and :func:`distribute_tree` places a tree by a tree of
specs.
"""

from __future__ import annotations

from typing import Optional, Tuple

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.config import ModelConfig
from repro_torch.launch.mesh import dp_axes, mesh_shape, model_size
from repro_torch.pytree import map_with_path, tree_map

# (parent, leaf) or leaf -> logical dims (layer dim added automatically for
# stacked leaves by matching rank)
LOGICAL = {
    "embed": ("vocab", "emb"),
    "lm_head": ("emb", "vocab"),
    "enc_in": ("emb", "emb2"),
    "wq": ("emb", "tp"),
    "wk": ("emb", "tp_kv"),
    "wv": ("emb", "tp_kv"),
    "wo": ("tp", "emb"),
    "bq": ("tp",),
    "bk": ("tp_kv",),
    "bv": ("tp_kv",),
    "w_up": ("emb", "tp"),
    "w_gate": ("emb", "tp"),
    "w_down": ("tp", "emb"),
    ("moe", "router"): ("emb", "rep"),
    ("moe", "w_up"): ("expert", "emb", "tp_inner"),
    ("moe", "w_gate"): ("expert", "emb", "tp_inner"),
    ("moe", "w_down"): ("expert", "tp_inner", "emb"),
    # mamba
    "in_proj": ("emb", "tp"),
    "out_proj": ("tp", "emb"),
    "conv_w": ("rep", "tp"),
    # rwkv
    "wr": ("emb", "tp"),
    "wg": ("emb", "tp"),
    "ck": ("emb", "tp"),
    "cv": ("tp", "emb"),
    "cr": ("emb", "tp"),
    "w_lora_a": ("emb", "rep"),
    "w_lora_b": ("rep", "emb"),
}

REPLICATED_LEAVES = {
    "scale", "bias", "a_log", "dt_bias", "d_skip", "out_norm", "mix",
    "cmix", "u", "w_base", "ln_x_scale", "ln_x_bias", "q_norm", "k_norm",
}


class P(tuple):
    """A partition spec: ``P(None, "data", "model")``, ``P(("pod",
    "data"), None)``; ``P()`` replicates every dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


def _names(path) -> Tuple[str, ...]:
    """A leaf's path as names: a ``"a/b/c"`` string or a sequence."""
    if isinstance(path, str):
        return tuple(path.split("/")) if path else ()
    return tuple(str(p) for p in path)


def _lookup(names: Tuple[str, ...]):
    leaf = names[-1]
    for parent in reversed(names[:-1]):
        if (parent, leaf) in LOGICAL:
            return LOGICAL[(parent, leaf)]
    return LOGICAL.get(leaf)


def _assign(logical: Tuple[str, ...], shape: Tuple[int, ...], mesh,
            *, fsdp: bool, cfg: Optional[ModelConfig] = None) -> P:
    from repro_torch.sharding.perf import FLAGS

    sizes = mesh_shape(mesh).shape
    nm = model_size(mesh)
    dp = dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= sizes[a]
    # rank difference = leading stacked dims (layers / slices): replicated
    extra = len(shape) - len(logical)
    spec = [None] * extra
    used_data = False
    for dim, size in zip(logical, shape[extra:]):
        ax = None
        if dim in ("tp", "tp_kv", "vocab") and nm > 1 and size % nm == 0:
            ax = "model"
            if FLAGS.strict_heads and cfg is not None and dim in ("tp", "tp_kv"):
                # only shard projections on heads when whole heads divide
                heads = cfg.n_heads if dim == "tp" else cfg.n_kv_heads
                is_attn = size in (cfg.n_heads * cfg.hd,
                                   cfg.n_kv_heads * cfg.hd)
                if is_attn and heads % nm != 0:
                    ax = None
        elif dim == "expert" and nm > 1 and size % nm == 0:
            ax = "model"
        elif dim in ("emb", "tp_inner") and not used_data:
            if (fsdp and FLAGS.fsdp_params and dp_total > 1
                    and size % dp_total == 0):
                ax = dp if len(dp) > 1 else dp[0]
                used_data = True
        spec.append(ax)
    return P(*spec)


def param_spec(cfg: ModelConfig, path, shape, mesh, *,
               fsdp: bool = True) -> P:
    names = _names(path)
    if names[-1] in REPLICATED_LEAVES:
        return P()
    logical = _lookup(names)
    if logical is None:
        return P()
    return _assign(logical, tuple(shape), mesh, fsdp=fsdp, cfg=cfg)


def tree_param_shardings(cfg: ModelConfig, tree, mesh, *,
                         fsdp: bool = True):
    """A tree of specs matching ``tree`` (works on meta tensors)."""
    return map_with_path(
        lambda path, leaf: param_spec(cfg, path, leaf.shape, mesh,
                                      fsdp=fsdp), tree)


# ---------------------------------------------------------------------------
# batches / caches / activations
# ---------------------------------------------------------------------------


def batch_axes_for(b: int, mesh) -> Optional[object]:
    """Largest prefix of the dp axes that divides the batch."""
    sizes = mesh_shape(mesh).shape
    dp = dp_axes(mesh)
    full = 1
    for a in dp:
        full *= sizes[a]
    if full > 1 and b % full == 0:
        return dp if len(dp) > 1 else dp[0]
    if "data" in dp and b % sizes["data"] == 0 and sizes["data"] > 1:
        return "data"
    if "pod" in dp and b % sizes["pod"] == 0 and sizes["pod"] > 1:
        return "pod"
    return None


def batch_spec(shape: Tuple[int, ...], mesh) -> P:
    ax = batch_axes_for(shape[0], mesh)
    return P(ax, *([None] * (len(shape) - 1)))


def tree_batch_shardings(tree, mesh):
    return tree_map(lambda leaf: batch_spec(tuple(leaf.shape), mesh), tree)


def cache_spec(cfg: ModelConfig, path, shape, mesh) -> P:
    """KV / state caches: (L|apps, B, S, KV, hd) or recurrent states."""
    names = _names(path)
    leaf = names[-1]
    nm = model_size(mesh)
    if leaf in ("k", "v") or "ckv" in names:
        l_, b, s, kv, hd = shape
        bx = batch_axes_for(b, mesh)
        if nm > 1 and kv % nm == 0:
            return P(None, bx, None, "model", None)
        if nm > 1 and s % nm == 0:
            # MQA long-context: shard the cache sequence (context parallel)
            return P(None, bx, "model", None, None)
        return P(None, bx, None, None, None)
    if leaf in ("wkv", "ssm"):                    # (L,B,H,dk,dv)
        l_, b, h = shape[:3]
        bx = batch_axes_for(b, mesh)
        ax = "model" if nm > 1 and h % nm == 0 else None
        return P(None, bx, ax, *([None] * (len(shape) - 3)))
    if leaf in ("shift_t", "shift_c", "conv"):
        b = shape[1]
        return P(None, batch_axes_for(b, mesh), *([None] * (len(shape) - 2)))
    if leaf == "len":
        return P()
    # fallback: shard dim-1 (batch) if divisible
    if len(shape) >= 2:
        return P(None, batch_axes_for(shape[1], mesh),
                 *([None] * (len(shape) - 2)))
    return P()


def tree_cache_shardings(cfg: ModelConfig, tree, mesh):
    return map_with_path(
        lambda path, leaf: cache_spec(cfg, path, tuple(leaf.shape), mesh),
        tree)


def opt_state_shardings(cfg: ModelConfig, state_tree, mesh,
                        *, fsdp: bool = True):
    """TrainState specs: params + AdamW moments (moments shard like
    params — together with fsdp=True this is ZeRO-2/3-style); the step
    counters replicate."""

    def f(path, leaf):
        names = _names(path)
        if names and names[-1] == "step":
            return P()
        # strip the TrainState/AdamWState wrappers (params/mu/nu prefix)
        for i, n in enumerate(names):
            if n in ("params", "mu", "nu"):
                names = names[i + 1:]
                break
        return param_spec(cfg, names, leaf.shape, mesh, fsdp=fsdp)

    return map_with_path(f, state_tree)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: each mesh dimension is
    ``Shard(d)`` for the tensor dim ``d`` that names it, else
    ``Replicate()``.  A tuple entry shards one tensor dim over several
    mesh dims, major to minor, as JAX does; its names must follow the
    mesh's order (DTensor splits a dim over mesh dims in that order)."""
    names = mesh_shape(mesh).names
    owner = {}
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec!r} names axis {a!r}, which "
                                 f"mesh {names} lacks")
            if a in owner:
                raise ValueError(f"spec {spec!r} uses axis {a!r} twice")
            owner[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"order {names}")
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in names)


def distribute_tree(tree, specs, mesh):
    """``tree`` with every leaf placed on ``mesh`` by its spec in
    ``specs`` (a tree of the same structure): plain tensors are
    distributed, DTensors redistributed where their placements differ."""

    def place(x, spec):
        want = to_placements(spec, mesh)
        if isinstance(x, DTensor):
            if tuple(x.placements) == want:
                return x
            return x.redistribute(mesh, want)
        return distribute_tensor(x, mesh, want)

    return tree_map(place, tree, specs)


def spec_leaves(specs, like) -> dict:
    """``{name: spec}`` of a spec tree shaped like ``like``, names as
    ``pytree.flatten_with_path`` gives ``like``'s (a spec is a tuple, so
    the spec tree is read at ``like``'s leaves)."""
    out = {}

    def visit(name, _):
        node = specs
        for k in name.split("/"):
            if isinstance(node, dict):
                node = node[k]
            elif isinstance(node, (list, tuple)):
                node = node[int(k)]
            else:
                node = getattr(node, k)
        out[name] = node

    map_with_path(visit, like)
    return out


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of the largest shard of a ``shape`` tensor laid out as
    ``spec`` on ``mesh`` (a mesh or a ``MeshShape``): each dim divided,
    rounded up as ``torch.chunk`` splits, by the sizes of the mesh axes
    that name it."""
    sizes = mesh_shape(mesh).shape
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[d] = -(-out[d] // sizes[a])
    return tuple(out)
