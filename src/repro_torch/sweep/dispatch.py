"""Sweep dispatch over the ranks of a process group (counterpart of
``repro.sweep.dispatch``).

A sweep's batch dimensions — design points within a compile group, and
programming trials within a point — are embarrassingly parallel, so they
shard over a 1-D ``data`` mesh of the process group's ranks (the
``launch.mesh`` axis conventions; parameters and calibration data stay
whole on every rank, like FSDP-off serving in ``sharding.rules``).

The reference places the batch with a ``NamedSharding`` and GSPMD
partitions one jitted evaluation.  The port's evaluators loop over
(point, trial) in Python (``sweep.evaluate``), so here each rank takes
its contiguous block of the chosen axis (:func:`shard_point_trial_batch`),
evaluates it, and :func:`gather_point_trial` collects the blocks
(``all_gather_object``) back into the reference's (points x trials)
order, so every rank returns the whole grid.  Trial seeds come from
``fold_seed(seed, t)`` whichever rank draws them, so a sharded grid
equals the serial one metric for metric.  Without a group, or with one
rank, :func:`sweep_mesh` is ``None`` and nothing is split.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: which axis :func:`shard_point_trial_batch` split
POINTS, TRIALS = 0, 1


def sweep_mesh(device_type: Optional[str] = None) -> Optional[DeviceMesh]:
    """1-D ``data`` mesh over the process group's ranks; None without a
    group or with one rank.  ``device_type`` defaults to ``cuda`` on an
    NCCL group, else ``cpu``."""
    if not dist.is_initialized() or dist.get_world_size() < 2:
        return None
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def _block(items: Sequence, mesh: DeviceMesh):
    """This rank's contiguous block of ``items`` (length divisible)."""
    k = len(items) // mesh.size(0)
    r = mesh.get_local_rank(0)
    return items[r * k:(r + 1) * k]


def shard_leading(items: Sequence, mesh: Optional[DeviceMesh]):
    """This rank's contiguous block of ``items`` (a list, or a tensor's
    leading dim) over the mesh's ``data`` axis; ``items`` itself when the
    mesh is absent or the length does not divide (replication is always
    correct; the divisibility rule mirrors ``sharding.rules``'s per-dim
    fallback)."""
    if mesh is None or len(items) % mesh.size(0):
        return items
    return _block(items, mesh)


def shard_point_trial_batch(rows: Sequence, seeds: Sequence,
                            mesh: Optional[DeviceMesh]
                            ) -> Tuple[list, list, Optional[int]]:
    """This rank's share of a group's design points (``rows``) and trial
    seeds, and which axis was split (:data:`POINTS`, :data:`TRIALS` or
    None).

    The reference's choice: design points when they divide the mesh and
    are at least the trials, else trials when they divide, else neither
    (every rank evaluates the whole group).  Exactly one axis is split.
    """
    rows, seeds = list(rows), list(seeds)
    if mesh is None:
        return rows, seeds, None
    n = mesh.size(0)
    if len(rows) % n == 0 and len(rows) >= len(seeds):
        return _block(rows, mesh), seeds, POINTS
    if len(seeds) % n == 0:
        return rows, _block(seeds, mesh), TRIALS
    return rows, seeds, None


def gather_point_trial(block: List[list], mesh: Optional[DeviceMesh],
                       axis: Optional[int]) -> List[list]:
    """The whole (points x trials) matrix from every rank's ``block`` of
    it, in the serial order; ``block`` itself when nothing was split."""
    if mesh is None or axis is None:
        return block
    parts: List[Optional[List[list]]] = [None] * mesh.size(0)
    dist.all_gather_object(parts, block, group=mesh.get_group(0))
    if axis == POINTS:
        return [row for part in parts for row in part]
    return [[v for part in parts for v in part[i]]
            for i in range(len(block))]
