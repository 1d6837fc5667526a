"""Partition-spec rules for a logical mesh (port of
``repro/dist/partition.py``).

Specs are derived per leaf from the leaf's tree path, its shape and the
mesh's axis sizes, never from a per-architecture table, so every config in
``configs.ARCHS`` gets one.  A spec is a tuple with one entry a dim: an
axis name, a tuple of axis names, or None (replicated), the entries of
the reference's ``PartitionSpec``; a 0-d or 1-d leaf gets ``()``.

* ``model`` (tensor-parallel) goes on the trailing feature dim of every
  matrix whose size divides the axis, and on the vocab dim of
  embedding-like tables (vocab-parallel); a vocab that does not divide
  the axis stays replicated on ``model``.
* ``data`` (FSDP) goes on the first remaining dim that divides the axis,
  only with ``fsdp=True`` (the HAR layout).
* 1-D leaves (biases, norm scales) and scalars are replicated.

Every rule is guarded by divisibility, so any mesh and arch give a valid,
possibly partly replicated, spec.  On one card (every axis of size 1)
every spec is all None: full replication.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.utils import tree_map

_EMBED_KEYS = ("embed", "unembed", "table", "head")


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def _map_path(fn, tree, path: Tuple[str, ...] = ()):
    """``tree`` with each tensor leaf ``x`` replaced by ``fn(path, x)``,
    ``path`` the dict keys and sequence indices down to it."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


# ---------------------------------------------------------------- params ---
def _param_spec(names: Tuple[str, ...], shape, sizes: Dict[str, int],
               fsdp: bool = False, moe_spec: str = "contract") -> tuple:
    """The spec of one parameter leaf at path ``names`` with ``shape``."""
    nd = len(shape)
    if nd <= 1:
        return ()
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1)
    axes = [None] * nd
    if any(n in _EMBED_KEYS for n in names):
        # vocab-parallel: the vocab dim is the larger of the two
        vdim = 0 if shape[0] >= shape[-1] else nd - 1
        if model_n > 1 and shape[vdim] % model_n == 0:
            axes[vdim] = "model"
        if fsdp and data_n > 1:
            other = nd - 1 if vdim == 0 else 0
            if axes[other] is None and shape[other] % data_n == 0:
                axes[other] = "data"
        return tuple(axes)
    if moe_spec == "expert" and "moe" in names and nd >= 3 \
            and model_n > 1 and shape[1] % model_n == 0:
        axes[1] = "model"
    elif model_n > 1:
        for d in (nd - 1, nd - 2):
            if shape[d] % model_n == 0:
                axes[d] = "model"
                break
    if fsdp and data_n > 1:
        for d in range(nd):
            if axes[d] is None and shape[d] % data_n == 0:
                axes[d] = "data"
                break
    return tuple(axes)


def param_specs(params, mesh, fsdp: bool = False,
                moe_spec: str = "contract"):
    """A spec per parameter leaf (tensors, meta tensors included), in the
    params' tree; ``moe_spec="expert"`` prefers the expert-count dim of
    the expert weights for ``model``."""
    sizes = _axis_sizes(mesh)
    return _map_path(lambda names, x: _param_spec(
        names, tuple(x.shape), sizes, fsdp, moe_spec), params)


# ---------------------------------------------------------------- batches --
def batch_specs(batch, mesh, batch_axes: Sequence[str] = ("data",)):
    """Shard each input's leading (global-batch) dim over the batch axes
    when it divides their product."""
    sizes = _axis_sizes(mesh)
    bt = tuple(a for a in batch_axes if sizes.get(a, 1) > 1) or \
        tuple(batch_axes)
    n = 1
    for a in bt:
        n *= sizes.get(a, 1)
    ax = bt if len(bt) > 1 else bt[0]

    def one(x: torch.Tensor):
        if x.ndim == 0 or x.shape[0] % n != 0:
            return ()
        return (ax,) + (None,) * (x.ndim - 1)

    return tree_map(one, batch)


# ---------------------------------------------------------------- caches ---
def cache_specs(caches, mesh, batch_shardable: bool = True,
                layout: str = "heads"):
    """Specs for stacked decode caches (leading dim = layers or
    super-blocks): the batch dim (1 after the stack dim, 0 for a rank-2
    leaf) over ``data`` when allowed, and with ``layout="heads"`` the
    head-count dim of rank >= 4 leaves over ``model``.  Recurrent-state
    dims stay whole."""
    sizes = _axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1)

    def one(x: torch.Tensor):
        shape, nd = tuple(x.shape), x.ndim
        if nd < 2:
            return ()
        axes = [None] * nd
        bdim = 1 if nd >= 3 else 0
        if batch_shardable and data_n > 1 and shape[bdim] % data_n == 0:
            axes[bdim] = "data"
        if layout == "heads" and nd >= 4 and model_n > 1 \
                and shape[nd - 2] % model_n == 0:
            axes[nd - 2] = "model"
        return tuple(axes)

    return tree_map(one, caches)
