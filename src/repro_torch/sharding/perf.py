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

The other helpers are the explicit actions the models take on a mesh
where DTensor has no strategy, one too costly to plan, or one that
leaves the work replicated (``launch/steps.py``): :func:`batch_rows` and
:func:`product_rows` (rows laid out by the batch rule, before a product
on both sides), :func:`contract_model` (a product split over ``model``
by its contraction or its columns), :func:`grad_layout` (a gradient laid
out as its value before a view), :func:`split_heads` (gather a dim the
heads cannot split), :func:`replicate_dims` (replicate a dim before an
op that needs it whole), :func:`local_embedding` and :func:`local_gather`
(a lookup or gather in each rank's shard of the table),
:func:`write_local` (an in-place cache write on each rank's shard, at
:func:`shard_offset`), :func:`local_attention` (attention on each
rank's own rows, KV heads, queries or cache positions),
:func:`local_recurrence` (the state recurrence on each rank's own rows
and heads) and :func:`local_channels` (a depthwise op on each rank's own
rows and channels).  Each leaves a plain tensor's path alone.

The card's torch (2.11) and the CPU build the tests run (2.13) plan some
DTensor ops differently; where they did, the layout is spelled out:
:func:`operand_like` and :func:`partial_to_shard` give an operand the
layout DTensor would give it inside an op (its gradient passed back as
it arrives), :func:`grad_rows` lays a gradient's rows over the whole
mesh, :func:`rows_to_columns` and :func:`layout_like` lay a tensor out
as a later op needs it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


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


def batch_rows(x):
    """``x`` (B, ...) laid out as the batch rule lays out a step's inputs
    (``rules.batch_spec``): rows over the dp axes that divide them, every
    other dim whole.  A plain tensor comes back unchanged."""
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.rules import batch_spec

    return constraint(x, *batch_spec(tuple(x.shape), x.device_mesh))


def local_embedding(table, tokens):
    """``table[tokens]``, on a mesh looked up by each rank in its own
    shard of a sharded table: DTensor's own plans for the lookup differ
    between torch versions (an indexed table's backward has no plan on
    the card's torch; ``F.embedding``'s masked partial sums lose their
    mask when the rows are laid out again), so the lookup is explicit,
    as vocabulary-parallel embeddings are written.

    Per mesh dim: where the tokens' rows are sharded (the batch rule),
    the table is whole and the rows stay sharded, unless the table's d
    is sharded there and all the tokens are fewer than a rank's rows of
    the table (then the tokens are gathered); where the table's
    vocabulary is sharded, each rank looks up the tokens in its rows and
    zeroes the rest, a partial sum that one rank's nonzero row makes
    exact; where its d is sharded, so is the result's.  The backward
    lays the gradient out the same way and adds each row's gradient
    into the rank's shard of the table's.  A plain or unsharded table
    takes ``table[tokens]``."""
    if not isinstance(table, DTensor) or not any(
            p.is_shard() for p in table.placements):
        return table[tokens]
    mesh = table.device_mesh
    tokens = batch_rows(_as_dtensor(tokens, mesh))
    # where all the tokens are fewer than a rank's rows of the table (a
    # decode step's), each mesh dim that splits the tokens' rows and the
    # table's d gathers the tokens, and the table stays split
    few = tokens.numel() < table.to_local().shape[0]
    want = tuple(Replicate() if few and q.is_shard(0) and p.is_shard(1)
                 else q for p, q in zip(table.placements, tokens.placements))
    if want != tuple(tokens.placements):
        tokens = tokens.redistribute(mesh, want)
    return _LocalGather.apply(table, tokens, False)


def local_gather(table, idx):
    """``table[idx]`` (``table`` (N, d), ``idx`` integers of any shape),
    on a mesh gathered by each rank from its own shard, as
    :func:`local_embedding` looks up, with ``idx`` laid out as it comes
    (a plain tensor is replicated) and the result's rows laid out as
    ``idx``.  The backward gathers the gradient's rows and their indices
    over each mesh dim that shards ``idx``, and adds them into the rank's
    shard of ``table``'s gradient in row order: a gradient as ``table``
    is laid out, not a partial sum of the whole table (cheaper where
    ``idx`` holds fewer rows than ``table``, as the MoE combine's
    tokens against its expert buffer).  No index op reaches DTensor,
    whose plans for an indexed DTensor's backward differ between torch
    versions (the card's torch writes rows past a shard).  A plain
    ``table`` takes ``table[idx]``."""
    if not isinstance(table, DTensor):
        return table[idx]
    return _LocalGather.apply(table, _as_dtensor(idx, table.device_mesh),
                              True)


class _LocalGather(torch.autograd.Function):
    """``table[tokens]`` from each rank's shard (:func:`local_embedding`,
    :func:`local_gather`).  Per mesh dim: tokens sharded by rows keep the
    table whole there and the result's rows sharded; a vocabulary shard
    gives a partial sum, one rank's nonzero row; a shard of d shards the
    result's last dim.  ``rows``: the backward gathers the gradient's
    rows over the mesh dims that shard the tokens' rows, where it would
    otherwise make the table's gradient a partial sum there."""

    @staticmethod
    def forward(ctx, table, tokens, rows):
        mesh = table.device_mesh
        t_pl, out_pl, g_pl = [], [], []
        for i, p in enumerate(table.placements):
            if tokens.placements[i].is_shard(0):
                t_pl.append(Replicate())
                out_pl.append(Shard(0))
                g_pl.append(Replicate() if rows else Partial())
            elif p.is_shard(0):
                t_pl.append(p)
                out_pl.append(Partial())
                g_pl.append(p)
            elif p.is_shard(1):
                t_pl.append(p)
                out_pl.append(Shard(tokens.ndim))
                g_pl.append(p)
            else:
                t_pl.append(Replicate())
                out_pl.append(Replicate())
                g_pl.append(Replicate())
        local = table.redistribute(mesh, tuple(t_pl)).to_local()
        offset = shard_offset(table.shape[0], mesh, t_pl, 0)
        idx = tokens.to_local().long() - offset
        inside = (idx >= 0) & (idx < local.shape[0])
        idx = torch.clamp(idx, 0, local.shape[0] - 1)
        out = torch.where(inside[..., None], local[idx],
                          torch.zeros((), dtype=local.dtype,
                                      device=local.device))
        ctx.save_for_backward(tokens.to_local() if rows else idx, inside)
        ctx.layout = (mesh, tuple(table.placements), tuple(out_pl),
                      tuple(g_pl), tuple(local.shape), rows,
                      tuple(tokens.placements), tuple(tokens.shape), offset)
        shape = tuple(tokens.shape) + (table.shape[1],)
        return DTensor.from_local(out, mesh, out_pl, run_check=False,
                                  shape=shape, stride=_contiguous(shape))

    @staticmethod
    def backward(ctx, grad):
        (mesh, table_pl, out_pl, g_pl, local_shape, rows, tok_pl,
         tok_shape, offset) = ctx.layout
        idx, inside = ctx.saved_tensors
        # the gradient of a partial sum is the whole gradient; with
        # ``rows`` every row of the token-sharded dims, and their indices
        want = tuple(Replicate() if p.is_partial() or (rows and p.is_shard(0))
                     else p for p in out_pl)
        g = grad.redistribute(mesh, want).to_local()
        if rows:
            whole = tuple(Replicate() if p.is_shard(0) else p for p in tok_pl)
            idx = DTensor.from_local(
                idx, mesh, tok_pl, run_check=False, shape=tok_shape,
                stride=_contiguous(tok_shape)).redistribute(
                    mesh, whole).to_local().long() - offset
            inside = (idx >= 0) & (idx < local_shape[0])
            idx = torch.clamp(idx, 0, local_shape[0] - 1)
        g = torch.where(inside[..., None], g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
        acc = torch.zeros(local_shape, dtype=g.dtype, device=g.device)
        acc.index_add_(0, idx.reshape(-1), g.reshape(-1, local_shape[1]))
        gt = DTensor.from_local(acc, mesh, g_pl, run_check=False)
        return gt.redistribute(mesh, table_pl), None, None


def product_rows(x):
    """``x`` (B, ..., d) laid out for the rows of one product ``x @ w``:
    B over the dp axes that divide it (the batch rule), d kept sharded
    over ``model`` where it is (a row-parallel product's input, the
    attention heads), every other dim whole and partial sums reduced.
    The values do not change.  A plain tensor comes back unchanged.

    DTensor would otherwise keep what the previous op left: its cost
    model counts communication only, so it defers partial sums and
    shards the contraction over ``data``, leaving every row on every
    rank and the product replicated over ``model``; GSPMD reduces and
    shards the rows.  And a dim sharded inside the flattened rows would
    become a strided shard, whose propagation reads shard offsets from a
    tensor (which a fake tensor cannot give)."""
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.rules import batch_spec

    mesh = x.device_mesh
    spec = list(batch_spec(tuple(x.shape), mesh))
    names = mesh.mesh_dim_names or ()
    if "model" in names and \
            x.placements[names.index("model")].is_shard(x.ndim - 1):
        spec[-1] = "model"
    return grad_layout(constraint(x, *spec))


def grad_layout(x):
    """``x`` unchanged, its gradient laid out as ``x`` is (a gradient
    arriving sharded along another dim would reach the view before it as
    a strided shard).  A plain tensor, or one that records no gradient,
    comes back as it is."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _GradLayout.apply(x, tuple(x.placements))


def grad_rows(x):
    """``x`` (T, ...) unchanged, its gradient laid out with its rows split
    over every mesh dim that divides them, every other dim whole: the
    backward of the product that made ``x`` then splits its rows over
    the whole mesh, and each rank computes its own rows' share (the two
    torch versions' planners otherwise differ: one split the rows, the
    other the product's other dim, leaving partial sums).  A plain
    tensor, or one that records no gradient, comes back as it is."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    mesh, rows, pl = x.device_mesh, x.shape[0], []
    for i in range(mesh.ndim):
        n = mesh.size(i)
        pl.append(Shard(0) if rows % n == 0 else Replicate())
        rows //= n if rows % n == 0 else 1
    return _GradLayout.apply(x, tuple(pl))


def contract_model(x, w):
    """``x`` (..., K) and ``w`` (K, N) laid out so that the product is
    split over ``model``: where ``w``'s K is sharded there, so is ``x``'s
    last dim (each rank multiplies its slice, a row-parallel product);
    where only ``x``'s is, ``w``'s K is sliced to match; where neither
    is, ``w``'s N is (a column-parallel product), unless it is already
    (an N the mesh does not divide is split as ``torch.chunk`` splits it,
    DTensor's uneven shard: rank 0's share is the largest).  Each is a
    local slice, no data moves,
    and no value changes; plain tensors come back unchanged.  DTensor
    would otherwise plan a product, or its backward's, whole on every
    rank of ``model`` where that moves nothing, the same work repeated
    on each (its cost model counts communication only)."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x, w
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names or w.device_mesh != mesh:
        return x, w
    i = names.index("model")
    n = mesh.size(i)
    if n == 1:
        return x, w

    def split(t, dim):
        pl = list(t.placements)
        pl[i] = Shard(dim)
        return t.redistribute(mesh, tuple(pl))

    k_w, k_x = w.placements[i].is_shard(0), x.placements[i].is_shard(
        x.ndim - 1)
    if k_w and not k_x and x.shape[-1] % n == 0:
        return split(x, x.ndim - 1), w
    if k_x and not k_w and w.shape[0] % n == 0:
        return x, split(w, 0)
    if not (k_w or k_x) and w.placements[i].is_replicate():
        return x, split(w, 1)
    return x, w


def contract_like(x, w, x_dim: int, w_dim: int):
    """``x`` laid out for a product that contracts its dim ``x_dim`` with
    ``w``'s dim ``w_dim``: on each mesh dim that shards ``w``'s, ``x``'s
    is sharded too (a partial sum reduced into the shard, a replicated
    dim sliced, another shard exchanged), so each rank multiplies its own
    slice, a partial sum, as GSPMD splits a product over its sharded
    contraction; on the other mesh dims ``x`` stays as it is.  The values
    do not change; plain tensors come back unchanged.  DTensor would
    otherwise plan by communication alone: on the two pods, arctic's
    experts kept their hidden activations a partial sum over ``data``,
    gathered ``w_down`` whole and ran the whole down product on every
    ``data`` rank."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x
    want = tuple(Shard(x_dim) if q.is_shard(w_dim) else p
                 for p, q in zip(x.placements, w.placements))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


class _GradLayout(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the forward
    value was: a gradient arriving in another layout would otherwise flow
    on into the backward of the view before it (a dim sharded where the
    view cannot unflatten it)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
            local = g.to_local()
            if not local.is_contiguous():
                # a shard gathered from uneven pieces is a slice of the
                # padded buffer, which the view before cannot take
                g = DTensor.from_local(local.contiguous(), g.device_mesh,
                                       ctx.placements, run_check=False,
                                       shape=g.shape, stride=g.stride())
        return g, None


def split_heads(x, heads: int):
    """``x`` (..., heads * hd) as (..., heads, hd).  On a mesh, a last dim
    sharded over a mesh dim whose size does not divide ``heads`` is
    gathered first: DTensor cannot unflatten a shard that splits a head
    (GSPMD keeps it split inside the heads).  The values do not change."""
    if isinstance(x, DTensor):
        mesh, last = x.device_mesh, x.ndim - 1
        want = tuple(Replicate() if p.is_shard(last)
                     and heads % mesh.size(i) else p
                     for i, p in enumerate(x.placements))
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
    return x.reshape(*x.shape[:-1], heads, x.shape[-1] // heads)


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


def operand_like(x, w, *pairs):
    """``x`` laid out for a product with ``w``: for each ``(x_dim,
    w_dim)`` of ``pairs``, on each mesh dim that shards ``w``'s
    ``w_dim``, ``x``'s ``x_dim`` is sharded too (a replicated dim
    sliced, another shard exchanged), so each rank multiplies its own
    slice; the other placements stay.  As with the layout DTensor gives
    an operand inside an op, the gradient passes back in the layout it
    arrives in (:func:`_relayout`).  Plain tensors come back unchanged."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x
    want = list(x.placements)
    for x_dim, w_dim in pairs:
        for i, q in enumerate(w.placements):
            if q.is_shard(w_dim):
                want[i] = Shard(x_dim)
    return _relayout(x, tuple(want))


def partial_to_shard(x, dim: int):
    """``x`` with each partial sum reduced into shards of tensor dim
    ``dim`` (a reduce-scatter); the other placements stay, and the
    gradient passes back in the layout it arrives in (:func:`_relayout`).
    A plain tensor comes back unchanged."""
    if not isinstance(x, DTensor):
        return x
    # one mesh dim at a time, major to minor: each a reduce-scatter (a
    # single redistribution of several would all-reduce one of them)
    for i, p in enumerate(x.placements):
        if p.is_partial():
            pl = list(x.placements)
            pl[i] = Shard(dim)
            x = _relayout(x, tuple(pl))
    return x


def _relayout(x, placements):
    """``x`` redistributed to ``placements``, its gradient passed back as
    it arrives: the layout DTensor gives an op's operand implicitly, where
    the two torch versions' planners choose differently, spelled out."""
    if tuple(x.placements) == tuple(placements):
        return x
    return _Relayout.apply(x, tuple(placements))


class _Relayout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, placements):
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g, None


def layout_like(x, ref):
    """``x`` laid out as the DTensor ``ref`` is (the same placements on
    the same mesh).  A plain ``x`` or ``ref`` leaves ``x`` unchanged."""
    if not (isinstance(x, DTensor) and isinstance(ref, DTensor)) \
            or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(x.device_mesh, ref.placements)


def rows_to_columns(x):
    """``x`` (N, d) with each mesh dim that shards its rows sharding its
    columns instead (an all-to-all); the other placements stay.  A plain
    tensor comes back unchanged."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(Shard(1) if p.is_shard(0) else p for p in x.placements)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def pad_dim(x, dim: int, n: int):
    """``x`` with ``n`` zeros appended along tensor dim ``dim``.  On a mesh
    each rank pads its own shard, ``dim`` made whole first: the card's
    torch cannot plan DTensor's ``constant_pad_nd`` on the prefill
    cache's layout (its redistribution plan indexes past the
    placements)."""
    dim %= x.ndim
    pad = [0, 0] * (x.ndim - 1 - dim) + [0, n]
    if not isinstance(x, DTensor):
        return F.pad(x, pad)
    x = replicate_dims(x, dim)
    shape = tuple(s + n if i == dim else s for i, s in enumerate(x.shape))
    return DTensor.from_local(F.pad(x.to_local(), pad), x.device_mesh,
                              x.placements, run_check=False, shape=shape,
                              stride=_contiguous(shape))


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
    offset = shard_offset(cache.shape[seq_dim], mesh, pl, seq_dim)
    write(cache.to_local(), new.to_local(), pos.to_local() - offset)


def shard_offset(length: int, mesh, placements, dim: int) -> int:
    """The global index at which this rank's shard of tensor dim ``dim``
    (``length`` long) starts, from its coordinates on ``mesh``: each mesh
    dim that shards ``dim`` splits the part before it as ``torch.chunk``
    does, major to minor (DTensor's split).  Plain integers: nothing is
    read from a tensor, so it holds on fake tensors too."""
    coord = mesh.get_coordinate()
    offset = 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            chunk = -(-length // mesh.size(i))
            start = min(coord[i] * chunk, length)
            length = min(start + chunk, length) - start
            offset += start
    return offset


def local_attention(attend, q, k, v, *, q_offset, kv_len, **kw):
    """``attend(q, k, v, q_offset=..., kv_len=..., **kw)`` run by each rank
    on its own block of rows, heads and cache positions, the DTensor
    result laid out as that block.

    Attention is independent per (row, KV head, query): q (B, Sq, H, hd),
    k and v (B, Skv, KV, hd) keep the batch sharding of the mesh dims that
    shard q's batch or k's (a cache stays where it is), and the heads of a
    mesh dim that shards q's heads when H divides it: with the KV heads
    too where KV divides it (a rank's q heads then use exactly its KV
    heads), else, where the mesh dim's size is a multiple of KV, each rank
    takes the one KV head its q heads share.  A mesh dim that shards the
    cache's positions (the rules' context-parallel cache) keeps them
    split where it does not shard the rows and either does not shard q's
    heads or q's (Sq x H) are fewer than the cache's (Skv x KV), so that
    a decode step gathers its query's heads, not the cache: each rank
    attends its own positions (``attend``'s ``kv_start``, and its
    ``partial`` softmax state), and the ranks fold their states
    together, the running max by an all-reduce max and the sums by
    all-reduce sums, as the online softmax folds its chunks.  A mesh dim that shards none of these splits the
    heads the same way where H divides it, else the queries where Sq
    does (``q_offset`` shifted to the rank's first query; K and V whole),
    else the heads padded to a multiple of the mesh dim, as GSPMD splits
    them (each rank its ``torch.chunk`` share of the q heads with their
    KV heads, zero heads up to ceil(H / n), cut off after and the heads
    gathered whole): otherwise every rank of that dim would attend
    every head and query, the same work replicated.  Every other dim is
    whole on every rank.  DTensor would otherwise propagate each of the
    online softmax's ops, and a product over a
    batch and a head dim both sharded plans its redistributions by a
    graph search, seconds per new shape.  Per-row ``q_offset``/``kv_len``
    (B,) are split like the rows; the arithmetic per (row, head) is the
    plain path's but for the fold of the position blocks."""
    from torch.distributed._functional_collectives import all_reduce

    mesh = next(t.device_mesh for t in (q, k, v) if isinstance(t, DTensor))
    whole = (Replicate(),) * mesh.ndim
    q_pl = tuple(q.placements) if isinstance(q, DTensor) else whole
    k_pl = tuple(k.placements) if isinstance(k, DTensor) else whole
    v_pl = tuple(v.placements) if isinstance(v, DTensor) else whole
    # what is left to split on each rank after the mesh dims before
    rows, heads, kv_heads, sq = q.shape[0], q.shape[2], k.shape[2], q.shape[1]
    pl, kv_pl, seq_dims, q_dims, pick = [], [], [], [], None
    padded = None
    for i, p in enumerate(q_pl):
        n = mesh.size(i)
        even = padded is None     # no uneven head split before this dim
        cache_split = k_pl[i].is_shard(1) and v_pl[i].is_shard(1)
        if (p.is_shard(0) or k_pl[i].is_shard(0)) and rows % n == 0:
            pl.append(Shard(0))
            kv_pl.append(Shard(0))
            rows //= n
        elif cache_split and sq * heads < k.shape[1] * kv_heads:
            # a cache split by positions holds more than the queries'
            # heads: the queries are gathered, not the cache
            pl.append(Replicate())
            kv_pl.append(Shard(1))
            seq_dims.append(i)
        elif (even and p.is_shard(2) and heads % n == 0
              and kv_heads % n == 0):
            pl.append(Shard(2))
            kv_pl.append(Shard(2))
            heads, kv_heads = heads // n, kv_heads // n
        elif (even and p.is_shard(2) and heads % n == 0
              and n % kv_heads == 0 and pick is None):
            pl.append(Shard(2))
            kv_pl.append(Replicate())
            pick = (i, n // kv_heads)
            heads, kv_heads = heads // n, 1
        elif cache_split:
            pl.append(Replicate())
            kv_pl.append(Shard(1))
            seq_dims.append(i)
        elif n == 1:
            pl.append(Replicate())
            kv_pl.append(Replicate())
        elif even and heads % n == 0 and kv_heads % n == 0:
            pl.append(Shard(2))
            kv_pl.append(Shard(2))
            heads, kv_heads = heads // n, kv_heads // n
        elif (even and heads % n == 0 and n % kv_heads == 0
              and pick is None):
            pl.append(Shard(2))
            kv_pl.append(Replicate())
            pick = (i, n // kv_heads)
            heads, kv_heads = heads // n, 1
        elif sq > 1 and sq % n == 0:
            pl.append(Shard(1))
            kv_pl.append(Replicate())
            q_dims.append(i)
            sq //= n
        elif even:
            # GSPMD's split of heads the mesh dim does not divide: each
            # rank its share of the heads padded to a multiple of n
            pl.append(Shard(2))
            kv_pl.append(Replicate())
            padded = i
            heads = -(-heads // n)
        else:
            pl.append(Replicate())
            kv_pl.append(Replicate())
    pl, kv_pl = tuple(pl), tuple(kv_pl)
    row_pl = tuple(p if p.is_shard(0) else Replicate() for p in pl)

    def block(t, placements, grad_placements=None):
        return _as_dtensor(t, mesh).redistribute(mesh, placements).to_local(
            grad_placements=grad_placements)

    def rows(x):
        if not isinstance(x, torch.Tensor):
            return x
        return block(x, row_pl if x.ndim else whole)

    # each rank's K/V gradient covers its own KV head, its own queries or
    # its own q heads: a partial sum
    part = set(q_dims) | ({pick[0]} if pick else set()) \
        | ({padded} if padded is not None else set())
    grad_pl = tuple(Partial() if d in part else p
                    for d, p in enumerate(kv_pl))
    kb, vb = block(k, kv_pl, grad_pl), block(v, kv_pl, grad_pl)
    # the global index of the rank's first KV head
    kv_base = shard_offset(k.shape[2], mesh, kv_pl, 2)
    if pick is not None:
        i, per = pick
        j = mesh.get_coordinate()[i] // per
        kb, vb = kb[:, :, j:j + 1], vb[:, :, j:j + 1]
        kv_base += j
    qb = block(q, pl)
    if padded is not None:
        # the rank's uneven share of the q heads and their KV heads (GQA's
        # head -> KV head map), zero heads up to ``heads``
        real = qb.shape[2]
        group = q.shape[2] // k.shape[2]
        first = shard_offset(q.shape[2], mesh, pl, 2)
        # the KV heads of the rank's real q heads, within its KV block; a
        # rank of padding only takes the first head of its own block
        kv_first = first // group - kv_base if real else 0
        kv_last = (first + real - 1) // group - kv_base if real \
            else kv_first
        if kv_first == kv_last:       # one KV head serves them all
            kb, vb = kb.narrow(2, kv_first, 1), vb.narrow(2, kv_first, 1)
        elif group == 1:
            # MHA: the same heads of K and V, a view (an index_select
            # would copy the rank's whole KV block: whisper's decode and
            # encoder cells would count those bytes)
            kb, vb = (_pad_heads(t.narrow(2, kv_first, real), 2, heads)
                      for t in (kb, vb))
        else:                         # each q head its own KV head
            idx = torch.div(torch.arange(first, first + real,
                                         device=qb.device), group,
                            rounding_mode="floor") - kv_base
            kb, vb = (_pad_heads(t.index_select(2, idx), 2, heads)
                      for t in (kb, vb))
        qb = _pad_heads(qb, 2, heads)
    args = (qb, kb, vb)
    q_offset = rows(q_offset)
    if q_dims:
        q_offset = q_offset + shard_offset(q.shape[1], mesh, pl, 1)
    kw.update(q_offset=q_offset, kv_len=rows(kv_len))
    if not seq_dims:
        out = attend(*args, **kw)
    else:
        from repro_torch.models.layers import finish_attention

        m, l, acc = attend(*args, **kw, partial=True,
                           kv_start=shard_offset(k.shape[1], mesh, kv_pl, 1))
        for i in seq_dims:
            group = mesh.get_group(i)
            top = all_reduce(m, "max", group)
            w = torch.exp(m - top)
            l = all_reduce(l * w, "sum", group)
            acc = all_reduce(acc * w[..., None], "sum", group)
            m = top
        out = finish_attention(l, acc, q.dtype)
    if padded is not None:
        out = out.narrow(2, 0, real)
    return _from_block(out.contiguous(), mesh, pl, q.shape,
                       whole=() if padded is None else (padded,))


def local_recurrence(fn, r, k, v, log_w, s0, *, u=None, **kw):
    """``fn(r, k, v, log_w, s0, u=u, **kw)``, ``fn`` one of
    ``models.recurrent``'s ``chunked_decay_recurrence`` (r/k/v/log_w
    (B, S, H, d)) or ``decay_step`` ((B, H, d)), run by each rank on its
    own block of rows and heads, the DTensor results (y, state) laid out
    as that block.

    The recurrence is independent per (row, head), as attention is: r, k,
    v, log_w and the state ``s0`` (B, H, dk, dv) keep the batch sharding
    of each mesh dim that shards one's rows and divides B, and the head
    sharding of each other mesh dim that shards one's heads, or shards
    nothing, and divides H (``u`` (H, dk) split the same way: a mesh dim
    left whole would repeat every rank's work).  A mesh dim that shards
    nothing and divides neither splits the heads as GSPMD does: each
    rank's shard of the uneven split (``torch.chunk``'s, which is GSPMD's
    split of the heads padded to a multiple of the mesh dim) is padded
    with zero heads to ceil(H / n), run, and cut back, and the results'
    heads are gathered whole again.  Every other dim is gathered whole,
    as :func:`split_heads` gathers heads the mesh cannot divide.
    DTensor would otherwise propagate every op of every chunk, and the
    contractions over a batch and a head dim both sharded meet a strided
    shard, whose propagation reads shard offsets from a tensor (which a
    fake tensor cannot give).  Each rank's arithmetic is the plain
    path's on its block; a plain call (no DTensor) goes straight
    through."""
    ins = (r, k, v, log_w, s0, u)
    dts = [t for t in ins if isinstance(t, DTensor)]
    if not dts:
        return fn(r, k, v, log_w, s0, u=u, **kw)
    mesh = dts[0].device_mesh
    hdim = r.ndim - 2
    bsz, heads = r.shape[0], r.shape[hdim]
    rows_left, heads_left = bsz, heads      # per rank, after the dims before
    pl = []
    for i in range(mesh.ndim):
        n = mesh.size(i)
        dims = [t.placements[i].dim for t in (r, k, v, log_w, s0)
                if isinstance(t, DTensor) and t.placements[i].is_shard()]
        heads_at = [d for t, d in ((r, hdim), (k, hdim), (v, hdim),
                                   (log_w, hdim), (s0, 1))
                    if isinstance(t, DTensor) and t.placements[i].is_shard(d)]
        if 0 in dims and rows_left % n == 0:
            pl.append("rows")
            rows_left //= n
        elif heads_left % n == 0 and (heads_at or not dims and n > 1):
            pl.append("heads")
            heads_left //= n
        elif not dims and n > 1:
            pl.append("padded")
            heads_left = -(-heads_left // n)
        else:
            pl.append(None)

    def place(dim_rows, dim_heads):
        return tuple(Shard(dim_rows) if p == "rows" else
                     Shard(dim_heads) if p in ("heads", "padded") else
                     Replicate() for p in pl)

    def block(t, placements, grad_placements=None):
        return _as_dtensor(t, mesh).redistribute(mesh, placements).to_local(
            grad_placements=grad_placements)

    x_pl, s_pl = place(0, hdim), place(0, 1)
    args = [block(t, x_pl) for t in (r, k, v, log_w)]
    args.append(None if s0 is None else block(s0, s_pl))
    if u is not None:
        # each rank's gradient covers its own rows: a partial sum
        u_grad = tuple(Partial() if p == "rows" else
                       Shard(0) if p in ("heads", "padded") else Replicate()
                       for p in pl)
        u = block(u, tuple(Shard(0) if p in ("heads", "padded") else
                           Replicate() for p in pl), u_grad)
    # the uneven head splits: each rank's share (from 0 to heads_left of
    # them) padded with zero heads up to heads_left, cut off after the
    # call, and gathered whole again (the callers merge heads with hd
    # next, which cannot keep a shard that splits the heads unevenly)
    whole = {i for i, p in enumerate(pl) if p == "padded"}
    if whole:
        real = args[0].shape[hdim]
        args = [_pad_heads(t, d, heads_left)
                for t, d in zip(args, (hdim,) * 4 + (1,))]
        u = _pad_heads(u, 0, heads_left)
    y, state = fn(*args, u=u, **kw)
    if whole:
        y = y.narrow(hdim, 0, real)
        state = state.narrow(1, 0, real).contiguous()
    y_shape = tuple(v.shape)
    s_shape = (bsz, heads, r.shape[-1], v.shape[-1])
    return (_from_block(y.contiguous(), mesh, x_pl, y_shape, whole),
            _from_block(state, mesh, s_pl, s_shape, whole))


def local_channels(fn, x, w):
    """``fn(x, w)``, a depthwise op along the sequence (``x`` (B, S, C),
    ``w`` (W, C), every channel its own; the result (B, S', C)), run by
    each rank on its own block of rows and channels, the DTensor result
    laid out as that block.  Per mesh dim: one that shards ``x``'s rows
    keeps them sharded (``w`` whole, its gradient a partial sum of the
    ranks' rows); one that shards ``w``'s channels splits ``x``'s the
    same way; any other is whole.  DTensor would otherwise plan each
    product of the window: the two torch versions differ (the card's
    gathered the rows to follow the window's layout), and a planned
    backward exchanges the saved operands.  A plain call goes straight
    through."""
    if not any(isinstance(t, DTensor) for t in (x, w)):
        return fn(x, w)
    mesh = next(t.device_mesh for t in (x, w) if isinstance(t, DTensor))
    whole = (Replicate(),) * mesh.ndim
    x_pl = tuple(x.placements) if isinstance(x, DTensor) else whole
    w_pl = tuple(w.placements) if isinstance(w, DTensor) else whole
    rows, cols, w_grad = [], [], []
    for i in range(mesh.ndim):
        if x_pl[i].is_shard(0):
            rows.append(Shard(0))
            cols.append(Replicate())
            w_grad.append(Partial())
        elif w_pl[i].is_shard(1):
            rows.append(Shard(2))
            cols.append(Shard(1))
            w_grad.append(Shard(1))
        else:
            rows.append(Replicate())
            cols.append(Replicate())
            w_grad.append(Replicate())
    rows = tuple(rows)
    xb = _as_dtensor(x, mesh).redistribute(mesh, rows).to_local()
    wb = _as_dtensor(w, mesh).redistribute(mesh, tuple(cols)).to_local(
        grad_placements=tuple(w_grad))
    y = fn(xb, wb)
    return _from_block(y.contiguous(), mesh, rows,
                       (x.shape[0], y.shape[1], x.shape[2]))


def _pad_heads(t, dim: int, width: int):
    """``t`` with zero heads appended along ``dim`` up to ``width`` (None
    stays None): a rank's share of heads split unevenly over a mesh dim,
    padded as GSPMD pads them to a multiple of the dim."""
    if t is None:
        return None
    return F.pad(t, [0, 0] * (t.ndim - 1 - dim) + [0, width - t.shape[dim]])


def _from_block(t, mesh, placements, shape, whole=()):
    """The DTensor of ``shape`` whose block on this rank is ``t``, laid
    out as ``placements``; the mesh dims in ``whole`` (the uneven head
    splits of :func:`_pad_heads`) then gathered whole again."""
    out = DTensor.from_local(t, mesh, placements, run_check=False,
                             shape=shape, stride=_contiguous(shape))
    if whole:
        out = out.redistribute(mesh, tuple(
            Replicate() if d in whole else p
            for d, p in enumerate(placements)))
    return out


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
