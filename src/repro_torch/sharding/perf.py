"""Performance-iteration flags and layout constraints (counterpart of
``repro.sharding.perf``).

Each flag is one hypothesis from the reference's hillclimbing log; the
baseline is all defaults.  Flags are process-global (set per variant by
:func:`variant`) and read when a step runs.

:func:`constraint` is the port's ``with_sharding_constraint``: on a
DTensor it redistributes to the placements the spec names on the
tensor's own mesh; on a plain tensor (no mesh) it returns the tensor
unchanged.  A layout constraint moves data and changes no value.  Where
the reference catches the failure of a spec that names an axis the mesh
lacks (``except Exception: return x``), the port checks the names first
and takes the reference's outcome: ``constraint`` leaves the tensor as
it is, and :func:`constrain_bs` falls to its next spelling.

Three helpers are the explicit actions the models take on a mesh where
DTensor has no strategy, or one too costly to plan
(``launch/steps.py``): :func:`replicate_dims` (replicate a dim before an
op that needs it whole), :func:`write_local` (an in-place cache write
on each rank's shard) and :func:`local_attention` (attention on each
rank's own rows and KV heads).  Each leaves a plain tensor's path alone.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


@dataclasses.dataclass
class PerfFlags:
    #: only shard attention q/kv projections on "model" when the *head
    #: count* divides the axis (instead of the flattened heads*hd dim) —
    #: avoids within-head splits and the involuntary-remat resharding storm
    strict_heads: bool = False
    #: context-parallel attention: shard the sequence dim over "model"
    #: around the attention block (for archs whose heads cannot shard)
    seq_parallel_attn: bool = False
    #: sharding constraint on the MoE dispatch buffers so the
    #: token->expert scatter lowers to an all-to-all instead of
    #: replicate+all-reduce
    moe_dispatch_sharding: bool = False
    #: gather expert weights over the data axis before the expert einsums
    #: (instead of all-reducing the f-dim contraction partial sums)
    moe_weight_gather: bool = False
    #: 2D expert parallelism: shard the capacity dim of the dispatch buffer
    #: over the data axis so expert compute distributes over all chips
    moe_cap_shard: bool = False
    #: FSDP (data-axis) sharding of parameters; turning it off for serve
    #: removes per-layer weight all-gathers at the cost of replicated
    #: weight memory
    fsdp_params: bool = True
    #: gradient-compression path for the cross-pod all-reduce (defined,
    #: read by nothing, as in the reference)
    compress_pod_grads: bool = False


FLAGS = PerfFlags()

VARIANTS = {
    "baseline": {},
    "strict_heads": {"strict_heads": True},
    "seqpar": {"strict_heads": True, "seq_parallel_attn": True},
    "moe_shard": {"moe_dispatch_sharding": True},
    "moe_shard_strict": {"moe_dispatch_sharding": True, "strict_heads": True},
    "nofsdp": {"fsdp_params": False},
    "nofsdp_strict": {"fsdp_params": False, "strict_heads": True},
    "all_serve": {"fsdp_params": False, "strict_heads": True,
                  "moe_dispatch_sharding": True},
    "nofsdp_seqpar": {"fsdp_params": False, "strict_heads": True,
                      "seq_parallel_attn": True},
    "moe_wgather": {"moe_weight_gather": True},
    "moe_ep2d": {"moe_weight_gather": True, "moe_cap_shard": True},
    "moe_wgather_seqpar": {"moe_weight_gather": True,
                           "seq_parallel_attn": True},
    "seqpar_nofsdp": {"strict_heads": True, "seq_parallel_attn": True,
                      "fsdp_params": False},
}


@contextlib.contextmanager
def variant(name: str):
    """Set ``VARIANTS[name]``'s flags for the block; every flag is as it
    was after it, on an exception too.  ``FLAGS`` stays one object, so a
    module that imported it sees the variant."""
    old = dataclasses.replace(FLAGS)
    for k, v in VARIANTS[name].items():
        setattr(FLAGS, k, v)
    try:
        yield FLAGS
    finally:
        for f in dataclasses.fields(PerfFlags):
            setattr(FLAGS, f.name, getattr(old, f.name))


def _axes(spec) -> tuple:
    out = []
    for entry in spec:
        out.extend(entry if isinstance(entry, tuple) else (entry,))
    return tuple(a for a in out if a is not None)


def _fits(x, spec) -> bool:
    """``x`` is a DTensor whose mesh has every axis ``spec`` names."""
    if not isinstance(x, DTensor):
        return False
    names = x.device_mesh.mesh_dim_names or ()
    return all(a in names for a in _axes(spec))


def constraint(x, *spec):
    """``x`` laid out as ``P(*spec)`` on its own mesh: redistributed if it
    is a DTensor whose mesh has the named axes, else ``x`` unchanged (a
    plain tensor has no mesh; the reference ignores a spec its mesh
    cannot take)."""
    if not _fits(x, spec):
        return x
    from repro_torch.sharding.rules import to_placements

    full = tuple(spec) + (None,) * (x.ndim - len(spec))
    want = to_placements(full, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_bs(x, *, seq: bool):
    """Constrain (B, S, ...) activations: batch over the dp axes, sequence
    over "model" when ``seq`` (whole-stream sequence parallelism).  The
    first of the reference's spellings ``("pod", "data")``, ``"data"``,
    ``None`` whose axes the mesh has is taken."""
    rest = [None] * (x.ndim - 2)
    for batch_ax in (("pod", "data"), "data", None):
        spec = (batch_ax, "model" if seq else None, *rest)
        if _fits(x, spec):
            return constraint(x, *spec)
    return x


def replicate_dims(x, *dims: int):
    """``x`` with tensor dims ``dims`` whole on every rank: each mesh dim
    that shards one of them (or holds a partial sum) replicates; the other
    placements stay.  A plain tensor comes back unchanged.  This is the
    explicit replication before an op that DTensor cannot run on a
    sharded dim."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    want = tuple(Replicate() if (p.is_partial() or (
        p.is_shard() and p.dim in dims)) else p for p in x.placements)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def write_local(write, cache, new, pos, *, seq_dim: int) -> None:
    """Run the in-place ``write(cache, new, pos)`` on each rank's own
    shard of the DTensor ``cache``: an index write cannot keep a sharded
    cache's placements (DTensor has no in-place strategy for it), and every
    rank owns the rows and heads it holds.  ``new`` (B, s, ...) is laid out
    like the cache with its ``seq_dim`` whole; ``pos`` (B, s), the global
    positions, is split by the cache's batch sharding and shifted to the
    shard's positions, so a position another rank holds falls outside and
    is dropped (``write`` drops positions outside ``[0, len)``).  A plain
    cache (made inside the step, so the same on every rank) takes ``new``
    and ``pos`` replicated."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if not isinstance(cache, DTensor):
        write(cache, _whole(new), _whole(pos))
        return
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    if any(p.is_partial() for p in pl):
        raise ValueError(f"cannot write into a partial cache {pl}")
    new_pl = tuple(Replicate() if p.is_shard(seq_dim) else p for p in pl)
    pos_pl = tuple(p if p.is_shard(0) else Replicate() for p in pl)
    new = _as_dtensor(new, mesh).redistribute(mesh, new_pl)
    pos = _as_dtensor(pos, mesh).redistribute(mesh, pos_pl)
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    write(cache.to_local(), new.to_local(), pos.to_local() - offset[seq_dim])


def local_attention(attend, q, k, v, *, q_offset, kv_len, **kw):
    """``attend(q, k, v, q_offset=..., kv_len=..., **kw)`` run by each rank
    on its own block of rows and KV heads, the DTensor result laid out as
    that block.

    Attention is independent per (row, KV head): q (B, Sq, H, hd), k and v
    (B, Skv, KV, hd) keep the batch sharding of q's mesh dims that shard
    its batch, and the heads of a mesh dim that shards q's heads when both
    H and KV divide it (a rank's q heads then use exactly its KV heads);
    every other dim is whole on every rank.  DTensor would otherwise
    propagate each of the online softmax's ops, and a product over a batch
    and a head dim both sharded plans its redistributions by a graph
    search, seconds per new shape.  Per-row ``q_offset``/``kv_len`` (B,)
    are split like the rows; the arithmetic per (row, head) is the plain
    path's."""
    mesh = next(t.device_mesh for t in (q, k, v) if isinstance(t, DTensor))
    q_pl = tuple(q.placements) if isinstance(q, DTensor) \
        else (Replicate(),) * mesh.ndim
    heads, kv_heads = q.shape[2], k.shape[2]
    pl = []
    for i, p in enumerate(q_pl):
        n = mesh.size(i)
        if p.is_shard(0) and q.shape[0] % n == 0:
            pl.append(Shard(0))
        elif p.is_shard(2) and heads % n == 0 and kv_heads % n == 0:
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    pl = tuple(pl)
    row_pl = tuple(p if p.is_shard(0) else Replicate() for p in pl)

    def block(t, placements):
        return _as_dtensor(t, mesh).redistribute(mesh, placements).to_local()

    def rows(x):
        if not isinstance(x, torch.Tensor):
            return x
        return block(x, row_pl if x.ndim else (Replicate(),) * mesh.ndim)

    out = attend(block(q, pl), block(k, pl), block(v, pl),
                 q_offset=rows(q_offset), kv_len=rows(kv_len), **kw)
    return DTensor.from_local(out.contiguous(), mesh, pl, run_check=False,
                              shape=q.shape, stride=_contiguous(q.shape))


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor is the same on every
    rank (``implicit_replication``'s reading), so it is replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _whole(x):
    """``x`` replicated on every rank, as a plain tensor."""
    return x.full_tensor() if isinstance(x, DTensor) else x
