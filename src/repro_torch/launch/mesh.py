"""Meshes (counterpart of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions: ``pod`` (the data-parallel axis between pods, crossed only by
gradient reductions), ``data`` (data parallelism and FSDP inside a pod)
and ``model`` (tensor and expert parallelism).  The sharding rules read
only a :class:`MeshShape`, the names and sizes, so they run on a shape
alone, as the reference's run on an ``AbstractMesh``; a ``DeviceMesh``
converts to one (:func:`mesh_shape`).

Kept as functions, never module-level meshes: building one needs a
process group, and importing this module starts none.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """The named dimensions of a mesh, major to minor."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.names) != len(self.sizes):
            raise ValueError(f"{len(self.names)} names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))


def mesh_shape(mesh) -> MeshShape:
    """``mesh`` as a :class:`MeshShape` (a ``DeviceMesh`` or a shape)."""
    if isinstance(mesh, MeshShape):
        return mesh
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("a DeviceMesh without mesh_dim_names has no "
                             "axes the rules can name")
        return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))
    raise TypeError(f"not a mesh: {mesh!r}")


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16 x 16 = 256 devices per pod; 2 pods = 512 devices multi-pod.
    Raises, naming the world size it needs, unless the process group has
    exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = _world_size()
    if have != need:
        raise ValueError(
            f"the {'x'.join(map(str, shape))} production mesh needs a "
            f"process group of {need} ranks; this one has {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 4,
                    device_type: str = "cuda") -> DeviceMesh:
    """A small ``("data", "model")`` mesh over the process group's ranks
    (the reference's 8-device subprocess tests; the port's gloo tests use
    2 x 2 on the CPU, path SO 1 x 1 on the card)."""
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel axis names present in ``mesh`` (pod included)."""
    names = mesh_shape(mesh).names
    return tuple(a for a in ("pod", "data") if a in names)


def model_size(mesh) -> int:
    return mesh_shape(mesh).shape.get("model", 1)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh).shape
    n = 1
    for a in dp_axes(mesh):
        n *= shape[a]
    return n
