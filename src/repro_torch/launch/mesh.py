"""Device meshes (port of ``repro/launch/mesh.py``).

A :class:`LogicalMesh` is axis names and sizes only, with no process
group: the partition rules in ``dist/partition.py`` read nothing else, and
a step built for one (``launch/steps.py``) carries its specs but runs
replicated, as the dry run's spec paths need.  :func:`device_mesh` turns
one into a ``torch.distributed`` ``DeviceMesh`` over the initialized
process group (gloo, NCCL, or the ``fake`` group that lets one process be
one rank of a large mesh); a step built for that runs sharded, on
DTensors.  The reference's roofline constants are its TPU's; the card's
figures belong to the tooling that reads them, not here.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class LogicalMesh(NamedTuple):
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_mesh(shape, axes) -> LogicalMesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         "differ in length")
    return LogicalMesh(tuple(axes), tuple(int(s) for s in shape))


def logical(mesh) -> LogicalMesh:
    """``mesh`` (a ``LogicalMesh`` or a ``DeviceMesh``) as axis names and
    sizes."""
    if isinstance(mesh, LogicalMesh):
        return mesh
    return LogicalMesh(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def is_device_mesh(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, LogicalMesh)


def device_mesh(mesh: LogicalMesh, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``mesh``'s axis names and sizes over the
    initialized process group, ranks laid out row-major.  Raises if the
    world size is not ``mesh.size``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialized process group")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"mesh {mesh.shape} has {mesh.size} devices but "
                         f"the world has {dist.get_world_size()} ranks")
    return init_device_mesh(device_type, mesh.axis_sizes,
                            mesh_dim_names=mesh.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The reference's production layouts: (data 16, model 16), or with
    ``multi_pod`` (pod 2, data 16, model 16)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def batch_axes(mesh) -> tuple:
    """Axes the global batch shards over."""
    return tuple(a for a in logical(mesh).axis_names
                 if a in ("pod", "data"))


def num_chips(mesh) -> int:
    return logical(mesh).size
