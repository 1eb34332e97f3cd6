"""Sweep dispatch on one device (counterpart of ``repro.sweep.dispatch``).

The reference shards a compile group's batch axes (design points, and
programming trials within a point) over a 1-D ``data`` mesh of every
local device.  The port runs on one card and evaluates a group's points
and trials in a Python loop (``repro_torch.sweep.evaluate``), so there is
nothing to place: :func:`sweep_mesh` returns ``None`` and the placement
helpers pass their inputs through unchanged.  Handing them a mesh raises,
so no caller believes it scaled out.  Sharding a sweep over cards is
ROADMAP queue A item 12 (scale-out).
"""

from __future__ import annotations

from typing import Optional


def _single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"repro_torch.sweep runs on one device; got mesh {mesh!r} "
            f"(sharding a sweep over cards is ROADMAP queue A item 12)")


def sweep_mesh() -> Optional[object]:
    """The sweep's device mesh: always ``None`` (one device)."""
    return None


def shard_leading(arr, mesh=None, axis: int = 0):
    """``arr`` itself; raises if given a mesh."""
    _single_device(mesh)
    return arr


def shard_point_trial_batch(dyn, keys, mesh=None):
    """``(dyn, keys)`` themselves; raises if given a mesh."""
    _single_device(mesh)
    return dyn, keys
