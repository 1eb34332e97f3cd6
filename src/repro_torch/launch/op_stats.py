"""Per-device roofline counts from the aten ops a step dispatches
(counterpart of ``repro.launch.hlo_stats``; the port has no HLO).

The reference parses the compiled per-device HLO.  Here one
:class:`OpStats` dispatch mode sees every op that runs on a rank's local
tensors inside its window (DTensor's own ops are passed on to DTensor,
which runs their local ops back through the mode), and counts per
device what ``hlo_stats`` counts per HLO op:

* **dot flops**: ``torch.utils.flop_counter``'s formulas (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, convolution, SDPA), which are the
  reference's dot rule, ``2 * numel(result) * K``.  Dots only, as there.
* **HBM bytes**: result bytes plus operand bytes of every op, except
  views and the no-cost ops of :data:`NO_COST_OPS` (the counterparts of
  ``hlo_stats.NO_COST_OPS``: allocation, ``arange`` for ``iota``, waits
  and metadata queries).  Nothing is fused in eager mode, so this is the
  same kind of upper bound as the reference's count over CPU HLO.
* **collective wire bytes** of the reference's five kinds
  (:data:`COLLECTIVES`), with its ring factors for group size n and its
  payload rule (``hlo_stats.py``): all-gather (n-1)/n of the result,
  reduce-scatter and all-to-all (n-1)/n and all-reduce 2(n-1)/n of the
  larger of result and operands, a point-to-point transfer 1 times its
  result, counted once at its receive as XLA counts a
  collective-permute once.  A collective of no kind (a broadcast or a
  scatter from one rank, which GSPMD never emits) raises.

Two departures from the reference, both from eager execution:

* **Trip weighting of two loops, on fake tensors only.**  The reference
  weights a while body by its trip count.  The port's step runs Python
  loops, and two of them are weighted where their steps have the same
  shapes: the recurrence's chunk loop (:func:`scan`, in
  ``models/recurrent.py``: the first and last chunk run and one middle
  chunk counts n - 2 times, forward and backward) and the train step's
  microbatch loop (:func:`trips`: one microbatch counts n times).  The
  weighted count equals the count of every step (flops, HBM bytes,
  collectives and the peak of live storage; held on the recurrent smoke
  cells).  On real tensors (the card) every step runs and is counted.
  Every other loop runs every iteration, and only the branch taken is
  counted: zamba2's per-layer conditional (attention on one layer in
  ``attn_every``) is counted exactly, where the reference takes the
  larger branch, an upper bound (``hlo_stats`` docstring).
* **Recurrences.**  The reference's three- and four-operand recurrence
  einsums (``repro/models/recurrent.py``) are dots to XLA; the port
  spells them as explicit products and sums (``models/recurrent.py``),
  which are not dots, so rwkv's and the Mamba2 hybrid's flops differ by
  those contractions.

The mode also tracks the live storage its ops create, for the dry-run's
``temp_size_in_bytes`` (:attr:`OpStats.peak_bytes`).  It counts real
tensors as well as fake ones: on the card it reads a real step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import types
import weakref
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: collective op name (the overload packet's, namespace dropped) -> kind
COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}

#: collectives that move no bytes of their own: the send half of a
#: point-to-point pair (its receive counts), and waits (``-done``)
COLLECTIVE_FREE = {"send", "wait_tensor", "_wrap_tensor_autograd", "barrier",
                   "monitored_barrier_"}

#: the namespaces of collective ops (a name of none of the maps raises)
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                         "_c10d_functional_autograd", "_dtensor")

#: ops that move no HBM bytes (``hlo_stats.NO_COST_OPS``: allocation,
#: ``iota``, constants); views are excluded by their schema
NO_COST_OPS = {
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "arange", "scalar_tensor", "lift_fresh",
    "_local_scalar_dense",
}


@dataclasses.dataclass
class OpSummary:
    """The fields of ``hlo_stats.HloSummary``, per device."""

    flops: float
    hbm_bytes: float
    coll_bytes: Dict[str, float]
    coll_counts: Dict[str, float]

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _active_fake_mode():
    """The fake mode entered around this op by someone else (a fake mode
    is an infra mode: it runs below every user mode, so the ops made
    under it reach :class:`OpStats` first)."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)


def _named_args(func, args, kwargs) -> dict:
    named = dict(kwargs)
    for a, v in zip(func._schema.arguments, args):
        named[a.name] = v
    return named


def group_size(func, args, kwargs) -> int:
    """The size of the group a collective op runs over: its
    ``group_size`` argument, else that of its group (by name or
    object)."""
    named = _named_args(func, args, kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    group = named.get("group_name", named.get("process_group"))
    if isinstance(group, str):
        group = dist.distributed_c10d._resolve_process_group(group)
    if group is None:
        raise ValueError(f"{func} names no group")
    return int(group.size())


def ring_factor(kind: str, n: int) -> float:
    """``hlo_stats``'s wire bytes per payload byte for a group of n."""
    if kind == "all-reduce":
        return 2.0 * (n - 1) / max(n, 1)
    if kind == "collective-permute":
        return 1.0
    return (n - 1) / max(n, 1)


class OpStats(TorchDispatchMode):
    """Count the ops dispatched on local tensors inside ``with
    OpStats(fake_mode) as s:``; read :meth:`summary` after.

    ``fake_mode`` is the ``FakeTensorMode`` whose fake tensors the step
    runs on (None on real tensors).  The mode runs each op under it, so
    a tensor the step makes is fake too, but never leaves it on the mode
    stack: DTensor's sharding propagation runs each new op once on fake
    global tensors under the fake mode it finds there, and so makes its
    own, whose ops are not the step's and are skipped.  ``watch``, if
    given, is called as ``watch(func, args, kwargs)`` with every op that
    reaches DTensor's dispatch inside the window, before DTensor plans
    it (its operands still DTensors); it counts nothing."""

    def __init__(self, fake_mode=None, *, trip_weighting: bool = True,
                 watch=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.trip_weighting = trip_weighting
        self.watch = watch
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes = {c: 0.0 for c in COLLECTIVES}
        self.coll_counts = {c: 0.0 for c in COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        #: what each op counts for (:meth:`repeat`)
        self.weight = 1
        self._made = None
        self._node_weight: Dict[int, int] = {}

    def summary(self) -> OpSummary:
        return OpSummary(self.flops, self.hbm_bytes, dict(self.coll_bytes),
                         dict(self.coll_counts))

    def _foreign(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor

        return any(isinstance(t, FakeTensor) and t.fake_mode is not
                   self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self.watch is not None:
                self.watch(func, args, kwargs)
            return NotImplemented         # DTensor runs it on local tensors
        ins = _tensors((args, kwargs))
        if self._foreign(ins) or _active_fake_mode() is not None:
            return func(*args, **kwargs)  # another fake mode's op
        with self.fake_mode or contextlib.nullcontext():
            out = func(*args, **kwargs)
        outs = _tensors(out)
        self._count(func, args, kwargs, ins, outs, out)
        self._track(outs)
        return out

    def _count(self, func, args, kwargs, ins, outs, out) -> None:
        packet = func.overloadpacket
        name = packet.__name__
        if func.namespace in COLLECTIVE_NAMESPACES:
            if name in COLLECTIVE_FREE:
                return
            kind = COLLECTIVE_KIND.get(name)
            if kind is None:
                raise ValueError(
                    f"collective {func} has no counterpart among the "
                    f"reference's kinds {COLLECTIVES}")
            # an in-place receive returns no tensor: its buffers are the
            # result
            res = sum(_nbytes(t) for t in (outs or ins))
            payload = res
            if kind in ("all-reduce", "reduce-scatter", "all-to-all"):
                payload = max(res, sum(_nbytes(t) for t in ins))
            n = 1 if kind == "collective-permute" else \
                group_size(func, args, kwargs)
            w = self._weight()
            self.coll_bytes[kind] += payload * ring_factor(kind, n) * w
            self.coll_counts[kind] += w
            return
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out) * self._weight()
        if not outs or name in NO_COST_OPS or _is_view(func):
            return
        self.hbm_bytes += sum(_nbytes(t) for t in outs + ins) * self._weight()

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            if self._made is not None:
                self._made.append(key)
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    @contextlib.contextmanager
    def repeat(self, n: int, *, keep: bool = True):
        """Count every op dispatched inside the block ``n`` times, as
        ``hlo_stats`` weights a while body by its trip count.  Storage
        the block made that is still live when it ends (what a body saves
        for its backward) counts ``n`` times from then on, but for what
        the block's ``once`` set names (its outputs, which n runs would
        replace step by step); the ``also`` set names storage made before
        it that n runs would hold n of (a carry the body saves).  A
        transient counts once, as n runs free each before the next; with
        ``keep`` False nothing the block made is scaled (a body that
        saves nothing for later)."""
        outer, made = self.weight, self._made
        self.weight, self._made = outer * n, []
        block = types.SimpleNamespace(once=[], also=[])
        try:
            yield block
        finally:
            once = {id(t.untyped_storage()) for t in block.once}
            keys = [k for k in self._made if keep and k not in once]
            keys += [id(t.untyped_storage()) for t in block.also]
            for key in set(keys):
                if key in self._live:
                    extra = self._live[key] * (n - 1)
                    self._live[key] += extra
                    self.live_bytes += extra
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self.weight, self._made = outer, made
            block.once.clear()
            block.also.clear()

    def repeat_backward(self, outputs, inputs, n: int) -> None:
        """Count ``n`` times every op the backward runs in the autograd
        nodes between ``outputs`` and ``inputs`` (the nodes a
        :meth:`repeat` block recorded), the adds that gather the
        gradients they hand on included (the engine runs those as the
        producing node)."""
        stop = {t.grad_fn for t in inputs
                if isinstance(t, torch.Tensor) and t.grad_fn is not None}
        todo = [t.grad_fn for t in outputs
                if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        seen = set()
        while todo:
            node = todo.pop()
            if node is None or node in stop or node in seen \
                    or type(node).__name__ == "AccumulateGrad":
                continue
            seen.add(node)
            self._node_weight[node._sequence_nr()] = self.weight * n
            todo.extend(f for f, _ in node.next_functions)

    def _weight(self) -> float:
        node = torch._C._current_autograd_node()
        if node is None:
            return self.weight
        return self._node_weight.get(node._sequence_nr(), self.weight)


def active_stats():
    """The :class:`OpStats` counting around this call, or None."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpStats):
            return mode
    return None


def _fake(tree) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t.to_local() if isinstance(t, DTensor) else t,
                          FakeTensor) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _weighting(tree):
    """The counting :class:`OpStats` if it weights trips and ``tree``'s
    tensors are fake, else None."""
    stats = active_stats()
    if stats is None or not stats.trip_weighting or not _fake(tree):
        return None
    return stats


def trips(items):
    """Iterate ``items``, the inputs of a loop's steps whose bodies have
    the same shapes and hand nothing on but through state the loop holds
    outside (the train step's microbatches: each adds its gradients into
    the accumulators), so that no step differs from another.  On real
    tensors every step runs.  On fake tensors under a trip-weighting
    :class:`OpStats` the first step runs alone and everything it
    dispatches, its backward included, counts n times.  Under an
    :class:`OpStats` the garbage of each step (its autograd graph's
    reference cycles) is collected before the next, so the peak of live
    storage does not depend on when Python's collector runs."""
    items = list(items)
    stats = active_stats()
    if len(items) > 1 and _weighting(items) is not None:
        with stats.repeat(len(items), keep=False):
            yield items[0]
        gc.collect()
        return
    for x in items:
        yield x
        if stats is not None:
            gc.collect()


def scan(body, carry, xs, consts=()):
    """``lax.scan`` over dim 1 of each tensor of ``xs``: ``carry, y =
    body(carry, slices, consts)`` once a slice, in order; returns the last
    carry and the ys concatenated along dim 1.

    On real tensors every step runs.  On fake tensors (the dry-run) with
    three or more steps, the first and the last run and one middle step
    stands for the other n - 2: :class:`OpStats` counts it, its backward
    and the accumulation of its gradients into ``consts`` n - 2 times,
    the slices' gradients are stacked as the steps' would be and its y
    stands in the concatenation for n - 2 (``hlo_stats`` weights a while
    body by its trip count).  Every step of the chunked recurrence has
    the same shapes, so the count is the same; the middle steps'
    transients are counted once at a time, as n steps free them."""
    n = xs[0].shape[1]
    stats = _weighting(xs) if n >= 3 else None
    if stats is None:
        parts = [torch.unbind(x, 1) for x in xs]
        ys = []
        for j in range(n):
            carry, y = body(carry, tuple(p[j] for p in parts), consts)
            ys.append(y)
        return carry, torch.cat(ys, 1)
    ends = [_Ends.apply(x, n) if x.requires_grad else
            (x[:, 0], x[:, 1], x[:, n - 1]) for x in xs]
    first, mid, last = ([e[i] for e in ends] for i in range(3))
    carry, y0 = body(carry, tuple(first), consts)
    before = carry
    with stats.repeat(n - 2) as block:
        carry, ym = body(carry, tuple(mid), consts)
        block.once += [carry, ym]
        if isinstance(before, torch.Tensor) and before.requires_grad:
            block.also.append(before)
    stats.repeat_backward((carry, ym), (before, *mid, *consts), n - 2)
    ys = _Repeat.apply(ym, n - 2)
    del ym, before           # n steps hold neither past the middle
    carry, yl = body(carry, tuple(last), consts)
    return carry, torch.cat([y0, ys, yl], 1)


class _Ends(torch.autograd.Function):
    """The first, a middle and the last slice along dim 1 of an ``n``-step
    input; the backward stacks the middle's gradient for the n - 2
    middle steps, as ``unbind``'s backward stacks n."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x[:, 0], x[:, 1], x[:, n - 1]

    @staticmethod
    def backward(ctx, g0, gm, gl):
        return torch.stack([g0] + [gm] * (ctx.n - 2) + [gl], 1), None


class _Repeat(torch.autograd.Function):
    """The middle step's y standing for n - 2 along dim 1 (storage only,
    no values: fake tensors); the backward passes on the first
    slice's gradient."""

    @staticmethod
    def forward(ctx, y, n):
        ctx.c = y.shape[1]
        shape = list(y.shape)
        shape[1] *= n
        return y.new_empty(shape)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, 0, ctx.c), None
