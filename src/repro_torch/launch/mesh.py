"""Logical device meshes (port of ``repro/launch/mesh.py``).

A mesh here is only axis names and sizes: the partition rules in
``dist/partition.py`` and the step builders in ``launch/steps.py`` read
nothing else, and one card runs every spec fully replicated.  The
reference's roofline constants are its TPU's; the card's figures belong
to the tooling that reads them, not here.
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


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The reference's production layouts: (data 16, model 16), or with
    ``multi_pod`` (pod 2, data 16, model 16)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def batch_axes(mesh) -> tuple:
    """Axes the global batch shards over."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def num_chips(mesh) -> int:
    return mesh.size
