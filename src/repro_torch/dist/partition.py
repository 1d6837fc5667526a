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

The mesh may be a ``LogicalMesh`` or a ``DeviceMesh``.  On a
``DeviceMesh``, :func:`to_placements` is the reference's
``to_shardings``: a spec becomes DTensor placements, one a mesh dim.
:func:`distribute_tree` places a tree of tensors by its specs, and
:func:`init_local` draws a model's params straight into each rank's
shards.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.utils import (tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)
from torch.utils._pytree import tree_flatten_with_path

_EMBED_KEYS = ("embed", "unembed", "table", "head")


def _axis_sizes(mesh) -> Dict[str, int]:
    from repro_torch.launch.mesh import logical
    return logical(mesh).shape


def is_spec(x) -> bool:
    """True for a spec: a plain tuple of None, axis names or tuples of
    them."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def spec_placements(spec, dmesh) -> tuple:
    """One spec as DTensor placements on ``dmesh``: ``Shard(d)`` on the
    mesh dim of each axis named at dim ``d`` (a tuple of axes nests them,
    the first outermost, which must be mesh order), ``Replicate()`` on
    every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(dmesh.mesh_dim_names)
    pl = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = [a for a in (entry if isinstance(entry, tuple) else (entry,))
                if a is not None]
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in mesh order {names}")
        for i in idx:
            pl[i] = Shard(d)
    return tuple(pl)


def to_placements(spec_tree, dmesh):
    """Spec tree -> tree of placement tuples (the reference's
    ``to_shardings``)."""
    return tree_map(lambda s: spec_placements(s, dmesh), spec_tree,
                    is_leaf=is_spec)


def _paired(tree, specs):
    """(tensor leaves of ``tree``, their specs, the tree's structure),
    each leaf paired with the spec at its key path (the two trees' dicts
    may list their keys in other orders)."""
    flat, struct = tree_flatten_with_path(tree)
    by_path = {tuple(map(str, p)): s for p, s in
               tree_flatten_with_path(specs, is_leaf=is_spec)[0]}
    if len(flat) != len(by_path):
        raise ValueError(f"{len(flat)} leaves but {len(by_path)} specs")
    return ([x for _, x in flat],
            [by_path[tuple(map(str, p))] for p, _ in flat], struct)


def distribute_tree(tree, specs, dmesh):
    """Every tensor leaf of ``tree`` (the same on every rank) as a DTensor
    placed by its spec; each rank keeps only its shard."""
    from repro_torch.dist import spmd
    leaves, spec_leaves, struct = _paired(tree, specs)
    out = []
    for x, s in zip(leaves, spec_leaves):
        pl = spec_placements(s, dmesh)
        out.append(spmd.wrap(x[spmd.local_slices(x.shape, pl, dmesh)]
                             .contiguous(), dmesh, pl, x.shape))
    return tree_unflatten(out, struct)


def empty_placed(tree, specs, dmesh, device, fill: bool = True):
    """Tensors of ``tree``'s shapes and dtypes (meta tensors), placed by
    ``specs``: each rank allocates only its shard.  With ``fill`` they are
    fresh caches, every float leaf zero and every int leaf (``slot_pos``)
    -1, the values ``transformer.init_cache`` starts from; without, they
    are left uninitialized."""
    from repro_torch.dist import spmd
    leaves, spec_leaves, struct = _paired(tree, specs)
    out = []
    for x, s in zip(leaves, spec_leaves):
        pl = spec_placements(s, dmesh)
        shape = [sl.stop - sl.start for sl in
                 spmd.local_slices(x.shape, pl, dmesh)]
        t = torch.empty(shape, dtype=x.dtype, device=device)
        if fill:
            t.fill_(0 if x.is_floating_point() else -1)
        out.append(spmd.wrap(t, dmesh, pl, x.shape))
    return tree_unflatten(out, struct)


def gather_tree(tree):
    """Every DTensor leaf of ``tree`` as the full plain tensor (a
    collective: every rank calls it)."""
    from repro_torch.dist import spmd
    return tree_map(lambda x: x.full_tensor() if spmd.is_dist(x) else x,
                    tree)


def init_local(seed: int, cfg, specs, dmesh, device="cuda"):
    """The params ``transformer.init_model(seed, cfg, device)`` draws, as
    DTensors placed by ``specs``, with only this rank's shards ever kept:
    the draws run one layer at a time in ``init_model``'s order, and each
    layer's shard is cut from it before the next is drawn.  At qwen2-72b
    a layer is 3.5 GB of f32 where the whole tree is 291 GB."""
    from repro_torch.models import transformer as T
    from repro_torch.dist import spmd
    shapes = T.init_abstract(cfg)
    leaves, spec_leaves, struct = _paired(shapes, specs)
    pls = [spec_placements(s, dmesh) for s in spec_leaves]
    keys = [tuple(str(getattr(k, "key", k)) for k in path) for path, _ in
            tree_flatten_with_path(shapes)[0]]
    cuts = {k: spmd.local_slices(x.shape, p, dmesh)
            for k, x, p in zip(keys, leaves, pls)}
    local = T.init_model(seed, cfg, device, where=cuts.__getitem__)
    flat = [spmd.wrap(t.contiguous(), dmesh, p, x.shape) for t, p, x in
            zip(tree_flatten(local)[0], pls, leaves)]
    return tree_unflatten(flat, struct)


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
