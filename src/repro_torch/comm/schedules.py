"""Layout-aware gradient-reduction schedules — LGR (paper §4.1), N-level,
port of ``repro/comm/schedules.py``.

The paper's schedules over the (gpu, inst[, dev]) instance grid:

* MPR  (multi-process reduction): stage every instance's gradient through
  host memory and reduce on the CPU (:func:`mpr_host`); inside one grid it
  degenerates to a flat reduce.
* MRR  (multi-ring reduction): one flat reduce over every grid axis.
* HAR  (hierarchical reduction): reduce-scatter within the fast domain,
  all-reduce across the slow ``gpu`` axis on the shrunken shards, then
  all-gather.  On a 3-axis grid the fast domain is the merged
  ``(inst, dev)`` plane.
* HAR3 (3-level hierarchical reduction): scatter ``dev``, scatter
  ``inst``, reduce ``gpu``, gather ``inst``, gather ``dev``.

Each schedule comes in two forms that compute the same sums:

(a) one process, grid-stacked tensors (:func:`lgr_allreduce`): every leaf
    carries the leading ``(g, t[, d])`` grid, and the collectives become
    sums and reshapes over those dims.  This is what GMIs that share one
    card in one process run (``Communicator.allreduce``).
(b) several ranks (:func:`make_grad_sync`, :func:`flat_psum`,
    :func:`hierarchical_psum`): ``torch.distributed`` reduce-scatter,
    all-reduce and all-gather over per-axis subgroups
    (:func:`axis_groups`), one rank per instance.

Sum-vs-mean semantics live in exactly ONE place: every schedule returns a
raw SUM; :func:`_finalize_average` applies the optional division.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils import tree_map

STRATEGIES = ("mpr", "mrr", "har", "har3")

# all_gather_into_tensor was renamed all_gather_single in newer torch
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


# ----------------------------------------------------- average (one place) --
def _finalize_average(tree, count: int, average: bool):
    """THE single sum-vs-mean switch: every schedule produces raw sums and
    every public entry point funnels through here (``average=True`` divides
    by the participant count, ``False`` returns the sum untouched)."""
    if not average:
        return tree
    return tree_map(lambda g: g / count, tree)


def _plan(strategy: str, axes: Sequence[str]):
    """``(reduce_axes, levels)`` of a schedule over ``axes`` (slow → fast):
    the axes of the all-reduce, and the scatter levels, slow → fast, each a
    tuple of axis names (a merged domain).  Flat schedules have no level.
    Rejects what the reference's ``make_grad_sync`` rejects."""
    axes = tuple(axes)
    if len(axes) < 2:
        raise ValueError(
            f"LGR schedules need at least a 2-axis (inter, intra) instance "
            f"grid; got axes {axes}")
    if strategy in ("mrr", "mpr"):
        return axes, []
    if strategy == "har":
        return axes[:1], [tuple(axes[1:])]
    if strategy == "har3":
        if len(axes) != 3:
            raise ValueError(
                f"har3 is the 3-level schedule and needs a 3-axis "
                f"(gpu, inst, dev) grid; got axes {axes} — use 'har' for "
                "2-level layouts")
        return axes[:1], [(axes[1],), (axes[2],)]
    raise ValueError(f"unknown reduction strategy {strategy!r}; "
                     f"expected one of {STRATEGIES}")


def _pad_flat(g: torch.Tensor, block: int) -> torch.Tensor:
    flat = g.reshape(-1)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))


# ---------------------------------------------------- (b) several ranks ----
def axis_groups(shape: Sequence[int], axes: Sequence[str]) -> Dict:
    """The calling rank's ``torch.distributed`` subgroups over an instance
    grid of ``shape`` whose ranks are laid out row-major: one per axis, one
    over all axes, and (on a 3-axis grid) one over the merged trailing
    axes.  Keys are tuples of axis names.  Group creation is collective:
    every rank calls this with the same arguments."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"grid {shape} does not match axes {axes}")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"grid {shape} needs {math.prod(shape)} ranks, "
                         f"the process group has {dist.get_world_size()}")
    rank, nd = dist.get_rank(), len(shape)
    ids = np.arange(math.prod(shape)).reshape(shape)
    keys = [axes] + [(a,) for a in axes] + ([axes[1:]] if nd > 2 else [])
    groups = {}
    for key in keys:
        dims = [axes.index(a) for a in key]
        size = math.prod(shape[d] for d in dims)
        rows = np.moveaxis(ids, dims, range(nd - len(dims), nd))
        for ranks in rows.reshape(-1, size):
            grp = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[key] = grp
    return groups


def _group(groups, key):
    if groups is None:
        raise ValueError("the collective schedules need groups= "
                         "(axis_groups) of an initialized process group")
    return groups[tuple(key)]


def flat_psum(grads, axis_names, groups=None):
    """MRR analogue: one flat all-reduce (raw sum) over the merged axes."""
    grp = _group(groups, axis_names)

    def one(g):
        out = g.clone()
        dist.all_reduce(out, group=grp)
        return out
    return tree_map(one, grads)


def hierarchical_psum(grads, axes: Sequence, groups=None):
    """N-level HAR (raw sum).  ``axes[0]`` is the slow reduce axis;
    ``axes[1:]`` are scatter levels ordered slow → fast, each an axis name
    or a tuple of names (a merged domain).  Scatters apply fastest level
    first, gathers undo them in reverse, on flattened leaves padded to the
    product of the scatter-level sizes."""
    reduce_grp = _group(groups, (axes[0],))
    levels = [tuple(a) if isinstance(a, (tuple, list)) else (a,)
              for a in axes[1:]]
    grps = [_group(groups, lvl) for lvl in levels]
    sizes = [dist.get_world_size(g) for g in grps]
    block = math.prod(sizes)

    def one(g):
        shard = _pad_flat(g, block)
        for grp, s in zip(reversed(grps), reversed(sizes)):   # fast first
            out = shard.new_empty(shard.numel() // s)
            dist.reduce_scatter_tensor(out, shard, group=grp)
            shard = out
        dist.all_reduce(shard, group=reduce_grp)
        for grp, s in zip(grps, sizes):     # undo scatters in reverse order
            out = shard.new_empty(shard.numel() * s)
            _all_gather(out, shard, group=grp)
            shard = out
        return shard[:g.numel()].reshape(g.shape)
    return tree_map(one, grads)


def make_grad_sync(strategy: str, axes: Sequence[str] = ("gpu", "inst"),
                   *, average: bool = True, groups=None) -> Callable:
    """Gradient-sync closure for one rank of a ``torch.distributed`` grid.

    ``axes`` is the instance grid ordered slow → fast, ``groups`` the
    rank's :func:`axis_groups` over it.  ``average`` divides the reduced
    sum by the participant count (via :func:`_finalize_average`), never
    inside a schedule."""
    axes = tuple(axes)
    reduce_axes, levels = _plan(strategy, axes)
    if levels:
        sync_sum = functools.partial(hierarchical_psum,
                                     axes=reduce_axes + tuple(levels),
                                     groups=groups)
    else:
        sync_sum = functools.partial(flat_psum, axis_names=reduce_axes,
                                     groups=groups)
    if not average:
        return sync_sum

    def sync(grads):
        count = dist.get_world_size(_group(groups, axes))
        return _finalize_average(sync_sum(grads), count, True)

    return sync


# ------------------------------------------------------------- host-staged -
def mpr_host(grads_per_instance: Sequence, *, average: bool = True):
    """True multi-process reduction for the submesh (MIG-like) backend:
    every instance's gradients are copied to host memory and summed there
    in instance order; the result stays on the CPU (the caller moves it to
    each instance)."""
    host_trees = [tree_map(lambda x: x.detach().cpu(), g)
                  for g in grads_per_instance]
    total = tree_map(lambda *xs: sum(xs), *host_trees)
    return _finalize_average(total, len(host_trees), average)


# ---------------------------------------------- (a) one process, stacked ---
def _merge(shape: Tuple[int, ...], dims) -> Tuple[Tuple[int, ...], int]:
    """``shape`` with the contiguous ``dims`` merged into one, and that
    dim's position."""
    d0, d1 = dims[0], dims[-1]
    return shape[:d0] + (math.prod(shape[d0:d1 + 1]),) + shape[d1 + 1:], d0


def _scatter(z: torch.Tensor, dims) -> torch.Tensor:
    """Reduce-scatter over the grid ``dims`` of ``z`` (grid + (m,)): the
    participant at index j of the (merged) level gets the sum of every
    participant's chunk j."""
    grid, m = tuple(z.shape[:-1]), z.shape[-1]
    merged, k = _merge(grid, dims)
    s = merged[k]
    tot = z.reshape(merged + (s, m // s)).sum(dim=k)
    return tot.movedim(-2, k).reshape(grid + (m // s,))


def _gather(z: torch.Tensor, dims) -> torch.Tensor:
    """All-gather over the grid ``dims``: every participant of the level
    gets the shards of all of them, concatenated in level order."""
    grid, m = tuple(z.shape[:-1]), z.shape[-1]
    merged, k = _merge(grid, dims)
    s = merged[k]
    cat = z.reshape(merged + (m,)).movedim(k, -2)
    cat = cat.reshape(cat.shape[:-2] + (s * m,)).unsqueeze(k)
    return cat.expand(merged[:k] + (s,) + merged[k + 1:] + (s * m,)) \
        .reshape(grid + (s * m,))


def lgr_allreduce(grads, grid, strategy: str, *, average: bool = True):
    """Run an LGR schedule over per-instance gradient replicas stacked on a
    leading instance grid: leaves are ``(g, t, ...)`` on a (gpu, inst)
    :class:`~repro_torch.core.gmi.InstanceGrid`, ``(g, t, d, ...)`` on a
    (gpu, inst, dev) one.  Returns the reduced (averaged by default)
    gradient with the same leading grid, every cell equal."""
    nd = len(grid.shape)
    if nd not in (2, 3):
        raise ValueError(
            f"LGR schedules reduce over a 2-axis (gpu, inst) or 3-axis "
            f"(gpu, inst, dev) instance grid; got axes {grid.axis_names}")
    axes = tuple(grid.axis_names)
    reduce_axes, levels = _plan(strategy, axes)
    red_dims = tuple(axes.index(a) for a in reduce_axes)
    lvl_dims = [[axes.index(a) for a in lvl] for lvl in levels]
    block = math.prod(math.prod(grid.shape[d] for d in dims)
                      for dims in lvl_dims)

    def one(x):
        g_shape = tuple(x.shape[:nd])
        if g_shape != grid.shape:
            raise ValueError(f"leaf grid {g_shape} does not match the "
                             f"instance grid {grid.shape}")
        z = x.reshape(g_shape + (-1,))
        n = z.shape[-1]
        z = torch.nn.functional.pad(z, (0, (-n) % block))
        for dims in reversed(lvl_dims):                     # fast first
            z = _scatter(z, dims)
        z = z.sum(dim=red_dims, keepdim=True).expand(z.shape)
        for dims in lvl_dims:               # undo scatters in reverse order
            z = _gather(z, dims)
        return z[..., :n].reshape(x.shape)

    return _finalize_average(tree_map(one, grads), math.prod(grid.shape),
                             average)
