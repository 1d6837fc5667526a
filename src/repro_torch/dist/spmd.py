"""The functional model on DTensors (``torch.distributed.tensor``).

Under a mesh (``launch/steps.py``) the params, Adam state, batch and
caches are DTensors placed by ``dist/partition.py``'s specs, and most of
the model runs on them as it is: DTensor's sharding propagation inserts
the collectives that XLA's SPMD pass inserts for the reference.  Three
kinds of region run on each rank's local tensors instead, between a
redistribution in and a wrap back out:

* attention (:class:`HeadLayout`): q, k and v are redistributed so that
  each rank holds whole heads, the batch over the batch axes and the
  query heads over ``model`` where the head count divides it; the kernel
  then takes local tensors, as a ctypes launch must;
* the recurrent blocks (:func:`local_region`): the batch over the batch
  axes, and each block's work split over ``model`` as its state is (a
  :class:`Region` says how far): Mamba2 on its heads, or with a state on
  its head dim p; the mLSTM on its value rows; the sLSTM's projections,
  and its recurrence on its heads where the cache splits them.  Each
  weight comes cut to the entries the rank computes with (a :class:`Cut`,
  one all-to-all over ``model``), never gathered whole.  A state leaf
  placed so is the rank's shard, written in place; the block's
  activations meet over ``model`` through :func:`region_gather`,
  :func:`region_sum` and :func:`region_grad_sum`, which pass a tensor
  unchanged where there is no region (``None``: one card);
* the mixture-of-experts routing, scatter and gather
  (``models/moe.py``): each rank's groups, the expert products on
  DTensors.

A plain tensor passes every helper unchanged, so one card runs the same
code with no mesh.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

BATCH_AXES = ("pod", "data")


def is_dist(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _names(dmesh) -> tuple:
    return tuple(dmesh.mesh_dim_names)


def axis_size(dmesh, name: str) -> int:
    names = _names(dmesh)
    return dmesh.size(names.index(name)) if name in names else 1


def axis_coord(dmesh, name: str) -> int:
    names = _names(dmesh)
    return dmesh.get_coordinate()[names.index(name)] if name in names else 0


def placements(dmesh, dims: dict) -> list:
    """Placements on ``dmesh`` that shard tensor dim ``d`` over the mesh
    dims ``dims[d]`` (mesh dim indices), the others replicated."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate()] * dmesh.ndim
    for d, mdims in dims.items():
        for md in mdims:
            pl[md] = Shard(d)
    return pl


def batch_dims(dmesh, n: int, axes: Sequence[str] = BATCH_AXES) -> tuple:
    """The mesh dims of ``axes`` that a batch of ``n`` shards over: all of
    them when their product divides ``n``, else none."""
    names = _names(dmesh)
    dims = tuple(i for i, a in enumerate(names) if a in axes
                 and dmesh.size(i) > 1)
    size = 1
    for i in dims:
        size *= dmesh.size(i)
    return dims if n % size == 0 else ()


def sharded_dims_of(pl, dim: int) -> tuple:
    """The mesh dims that placements ``pl`` shard tensor dim ``dim``
    over."""
    from torch.distributed.tensor import Shard
    return tuple(i for i, p in enumerate(pl)
                 if isinstance(p, Shard) and p.dim == dim)


def sharded_dims(x, dim: int) -> tuple:
    """The mesh dims that shard tensor dim ``dim`` of DTensor ``x``."""
    return sharded_dims_of(x.placements, dim)


def local_slices(shape, pl, dmesh) -> tuple:
    """This rank's index into a tensor of ``shape`` placed by ``pl``: a
    slice a dim (nested shards split in mesh order)."""
    from torch.distributed.tensor import Shard
    coord = dmesh.get_coordinate()
    start = [0] * len(shape)
    size = list(shape)
    for md, p in enumerate(pl):
        if isinstance(p, Shard):
            n = dmesh.size(md)
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over {n}")
            size[p.dim] //= n
            start[p.dim] += coord[md] * size[p.dim]
    return tuple(slice(s, s + n) for s, n in zip(start, size))


def layout(x, pl):
    """DTensor ``x`` redistributed to ``pl`` (itself when it is so)."""
    pl = list(pl)
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh,
                                                              pl)


def wrap(t: torch.Tensor, dmesh, pl, shape) -> "torch.Tensor":
    """The DTensor whose local tensor on this rank is ``t`` (made
    contiguous, as the global stride says), placed by ``pl``, of global
    ``shape`` (every split here is even)."""
    from torch.distributed.tensor import DTensor
    t = t.contiguous()
    shape = tuple(shape)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(t, dmesh, pl, run_check=False, shape=shape,
                              stride=tuple(stride))


def local(x, dmesh, pl, partial_over=()) -> torch.Tensor:
    """This rank's part of ``x`` under placements ``pl``: a DTensor is
    redistributed, a plain tensor (the same on every rank) is cut.  The
    gradient of the local tensor is taken as a partial sum over the mesh
    dims ``partial_over`` (those over which ranks use their copies on
    different data, as the batch rows of a local region), to be summed
    when it flows back into ``x``."""
    from torch.distributed.tensor import Partial
    if not is_dist(x):
        from torch.distributed.tensor import Replicate
        x = wrap(x, dmesh, [Replicate()] * dmesh.ndim, x.shape)
    x = layout(x, pl)
    if not partial_over:
        return x.to_local()
    return x.to_local(grad_placements=[
        Partial() if md in partial_over else p
        for md, p in enumerate(x.placements)])


def reduced(pl) -> list:
    """``pl`` with every partial placement replaced by a replicated one."""
    from torch.distributed.tensor import Partial, Replicate
    return [Replicate() if isinstance(p, Partial) else p for p in pl]


def pad(x, amounts):
    """``F.pad(x, amounts)`` (constant zeros); a DTensor is padded on each
    rank's local tensor, the padded dims gathered first where split, so
    DTensor's own pad (which some versions cannot redistribute for) is
    never asked."""
    import torch.nn.functional as F
    if not is_dist(x):
        return F.pad(x, amounts)
    shape = list(x.shape)
    for i in range(0, len(amounts), 2):
        d = x.ndim - 1 - i // 2
        if amounts[i] or amounts[i + 1]:
            x = unshard_dim(x, d)
            shape[d] += amounts[i] + amounts[i + 1]
    return wrap(F.pad(x.to_local(), amounts), x.device_mesh, x.placements,
                shape)


def unshard_dim(x, dim: int):
    """``x`` with every mesh dim that shards tensor dim ``dim`` gathered
    (a plain tensor as it is)."""
    if not is_dist(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    return layout(x, pl)


def constrain(x, spec):
    """The reference's ``with_sharding_constraint``: DTensor ``x``
    redistributed to ``spec`` (one entry a dim: an axis name, a tuple of
    them or None; axes the mesh lacks are dropped, and so is an entry
    whose axes do not divide its dim).  A plain tensor, or a None spec,
    passes as it is."""
    if spec is None or not is_dist(x):
        return x
    dmesh = x.device_mesh
    names = _names(dmesh)
    dims = {}
    for d, e in enumerate(tuple(spec)[:x.ndim]):
        axes = [a for a in (e if isinstance(e, tuple) else (e,))
                if a in names]
        mdims = [names.index(a) for a in axes]
        n = 1
        for md in mdims:
            n *= dmesh.size(md)
        if mdims and x.shape[d] % n == 0:
            dims[d] = mdims
    return layout(x, placements(dmesh, dims))


def vocab_lookup(table, tokens):
    """``table[tokens]`` for a DTensor ``table`` (V, D), the vocab dim
    sharded over ``model`` or not: every rank looks its batch rows' tokens
    up in the rows it holds (zeros for the others), and a sum over
    ``model`` completes them.  Returns (B, ..., D) with the batch over
    the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dmesh = table.device_mesh
    vdims = sharded_dims(table, 0)
    tab = layout(table, [p if isinstance(p, Shard) and p.dim == 0
                         else Replicate() for p in table.placements])
    bd = batch_dims(dmesh, tokens.shape[0])
    tok = local(tokens, dmesh, placements(dmesh, {0: list(bd)})).long()
    tl = local(tab, dmesh, tab.placements, bd)
    idx = tok - _vocab_offset(dmesh, vdims, tl.shape[0])
    hit = (idx >= 0) & (idx < tl.shape[0])
    rows = _Rows.apply(tl, torch.where(hit, idx, 0), hit)
    pl = placements(dmesh, {0: list(bd)})
    for md in vdims:
        pl[md] = Partial()
    out = wrap(rows, dmesh, pl, tuple(tokens.shape) + (table.shape[1],))
    return layout(out, reduced(pl))


class _Rows(torch.autograd.Function):
    """``table[idx] * hit`` whose backward adds the gradient rows into a
    zero table with ``index_add_``.  Indexing's own backward
    (``index_put_`` with accumulate) sorts and copies the gradient rows
    inside one aten call on the card, a temporary of tokens x d_model
    that no op counter sees and a rank's peak would miss."""

    @staticmethod
    def forward(ctx, table, idx, hit):
        ctx.save_for_backward(idx, hit)
        ctx.rows = table.shape[0]
        return table[idx] * hit[..., None].to(table.dtype)

    @staticmethod
    def backward(ctx, g):
        idx, hit = ctx.saved_tensors
        D = g.shape[-1]
        gt = g.new_zeros((ctx.rows, D))
        gt.index_add_(0, idx.reshape(-1),
                      (g * hit[..., None].to(g.dtype)).reshape(-1, D))
        return gt, None, None


def _vocab_offset(dmesh, vdims, n_local: int) -> int:
    off = 0
    for md in vdims:
        # nested shards split in mesh order
        off = off * dmesh.size(md) + dmesh.get_coordinate()[md]
    return off * n_local


def _over(t, dmesh, bd, vdims, op: str):
    """Local (B, ...) ``t`` reduced with ``op`` over the mesh dims
    ``vdims``: this rank's rows of the result."""
    from torch.distributed.tensor import Partial
    pl = placements(dmesh, {0: list(bd)})
    for md in vdims:
        pl[md] = Partial(op)
    nb = 1
    for md in bd:
        nb *= dmesh.size(md)
    x = wrap(t, dmesh, pl, (t.shape[0] * nb,) + tuple(t.shape[1:]))
    return layout(x, reduced(pl)).to_local()


def vocab_xent(logits, labels):
    """(log-sum-exp, logit of the label), each (B, L), of DTensor logits
    (B, L, V) whose vocab dim may be sharded over ``model``
    (vocab-parallel): each rank reduces the vocab rows it holds, and
    three all-reduces of (B, L) values over ``model`` (the max, the sum of
    exponentials, the picked logit) complete them; the logits themselves
    are never gathered.  Both come back with the batch over the batch
    axes."""
    dmesh = logits.device_mesh
    bd, vdims = sharded_dims(logits, 0), sharded_dims(logits, 2)
    ll = layout(logits, placements(dmesh, {0: list(bd), 2: list(vdims)})) \
        .to_local()
    lab = local(labels, dmesh, placements(dmesh, {0: list(bd)})).long()
    m = _over(ll.detach().amax(-1), dmesh, bd, vdims, "max")
    s = _over(torch.exp(ll - m[..., None]).sum(-1), dmesh, bd, vdims, "sum")
    lse = torch.log(s) + m
    idx = lab - _vocab_offset(dmesh, vdims, ll.shape[-1])
    hit = (idx >= 0) & (idx < ll.shape[-1])
    got = torch.gather(ll, -1, torch.where(hit, idx, 0)[..., None])[..., 0]
    picked = _over(got * hit.to(got.dtype), dmesh, bd, vdims, "sum")
    bpl = placements(dmesh, {0: list(bd)})
    return (wrap(lse, dmesh, bpl, labels.shape),
            wrap(picked, dmesh, bpl, labels.shape))


def _rms_norm_of_part(scale, x, width: int, eps: float, total):
    """``layers.rms_norm`` over ``width`` features of which ``x`` holds a
    part (``scale`` their entries): ``total`` completes this rank's sums
    of squares, a value a row, into the whole row's."""
    x32 = x.float()
    ss = total(torch.sum(torch.square(x32), -1, keepdim=True))
    return (x32 * torch.rsqrt(ss / width + eps) * scale).to(x.dtype)


def rms_norm_split(scale, x, eps: float):
    """``layers.rms_norm`` of DTensor ``x`` whose features (last dim) are
    split: each rank sums its squares and one all-reduce of a value a row
    completes them, whose gradient is reduced back the same way.  Left to
    DTensor, the mean's backward re-splits the rows over ``model`` and
    moves the whole activation twice."""
    from torch.distributed.tensor import Partial
    dm = x.device_mesh
    last = x.ndim - 1
    md = sharded_dims(x, last)
    pl = [Partial() if i in md else p for i, p in enumerate(x.placements)]

    def total(ss):
        ss = wrap(ss, dm, pl, tuple(x.shape[:-1]) + (1,))
        return layout(ss, reduced(pl)).to_local(grad_placements=pl)
    sc = local(scale, dm, placements(dm, {0: list(md)}),
               sharded_dims(x, 0))
    y = _rms_norm_of_part(sc, x.to_local(), x.shape[-1], eps, total)
    return wrap(y, dm, x.placements, x.shape)


# --------------------------------------------------------------- linears ---
def _batch_only(x) -> list:
    """``x``'s placements with only its batch (dim 0) shards kept."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]


def features(x):
    """DTensor ``x`` with whole features on its batch rows: the one
    gather a block's column-parallel products share."""
    return layout(x, _batch_only(x))


def col(x, params):
    """``x @ w (+ b)`` for a weight whose output (last) dim may be split
    over ``model`` (column-parallel): ``x`` is gathered to whole features
    on its batch rows, ``w`` (cast to ``x``'s type first) to whole rows,
    and the output comes back split as ``w``'s columns are."""
    from torch.distributed.tensor import Replicate, Shard
    w = params["w"].to(x.dtype)
    last = w.ndim - 1
    w = layout(w, [p if isinstance(p, Shard) and p.dim == last
                   else Replicate() for p in w.placements])
    y = features(x) @ w
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


class _GradLayout(torch.autograd.Function):
    """The identity, whose gradient is redistributed to ``pl`` on its way
    back."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return layout(g, ctx.pl), None


def row(h, params):
    """``h @ w`` for ``h`` whose features (last dim) may be split over
    ``model`` (row-parallel): ``w`` (cast to ``h``'s type) is laid out
    with its rows split the same way, and the output is a partial sum
    over those mesh dims, for the caller's constraint to reduce.  The
    output's gradient is summed (made whole over those dims) before the
    product's backward: left a partial sum, DTensor may gather ``h`` and
    ``w`` whole and compute both gradients in full on every rank, as
    PyTorch 2.13's sharding propagation does (ROADMAP C18)."""
    w = params["w"].to(h.dtype)
    md = sharded_dims(h, h.ndim - 1)
    h = layout(h, placements(h.device_mesh, {
        0: list(sharded_dims(h, 0)), h.ndim - 1: list(md)}))
    y = h @ layout(w, placements(w.device_mesh, {0: list(md)}))
    return _GradLayout.apply(y, reduced(y.placements))


# ----------------------------------------------------- stacked layers -----
class _StackLayer(torch.autograd.Function):
    """Layer ``j`` of the rank ``owner`` of ``group`` holds, broadcast
    from it.  The gradient arrives summed over the group already (the
    layer's DTensor is replicated there, so DTensor reduces its partial
    gradients before handing them back) and goes to the owner's slot."""

    @staticmethod
    def forward(ctx, local, j, owner, group):
        import torch.distributed as dist
        mine = dist.get_rank(group) == owner
        buf = local[j].clone() if mine else local.new_empty(local.shape[1:])
        src = dist.get_global_rank(group, owner)
        dist.broadcast(buf, src=src, group=group)
        ctx.j, ctx.owner, ctx.group, ctx.mine = j, owner, group, mine
        ctx.shape = local.shape
        return buf

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        if ctx.mine:
            out[ctx.j] = g
        return out, None, None, None


def stack_layer(x, i: int):
    """Layer ``i`` of a stacked DTensor ``x`` whose layer dim (0) is split
    over one mesh dim (FSDP on the layer dim): only that layer is
    gathered, from the rank holding it, and its gradient goes back to
    that rank.  The other placements move down a dim."""
    from torch.distributed.tensor import Replicate, Shard
    dm = x.device_mesh
    (md,) = sharded_dims(x, 0)
    loc = x.to_local()
    n = loc.shape[0]
    piece = _StackLayer.apply(loc, i % n, i // n, dm.get_group(md))
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 0 else
          Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in x.placements]
    return wrap(piece, dm, pl, x.shape[1:])


# ------------------------------------------------------------ attention ---
class HeadLayout:
    """Where each rank's attention runs: the batch over the batch axes
    (those of the cache's batch dim when there is a cache), the query
    heads over ``model`` when ``num_heads`` divides it, and the kv heads
    over ``model`` when the cache (or, without one, ``num_kv_heads``)
    splits them so.  Otherwise the kv heads are gathered whole and each
    rank takes the ones its query heads meet (``kv_sel``): query head
    ``h`` meets kv head ``h // (H / H_kv)``.  Where the query heads do not
    divide ``model``, or a rank's heads would meet a part of a kv head's
    group that another rank also needs in an uneven way, every head runs
    on every rank, replicated, as XLA would run them."""

    def __init__(self, dmesh, B: int, H: int, KH: int, cache=None):
        self.dmesh = dmesh
        names = _names(dmesh)
        if cache is not None and is_dist(cache[0]):
            self.bdims = sharded_dims(cache[0], 0)
        else:
            self.bdims = batch_dims(dmesh, B)
        m = axis_size(dmesh, "model")
        G = H // KH
        Hl = H // m if m > 1 and H % m == 0 else H
        self.mdim = names.index("model") if Hl < H \
            and (Hl % G == 0 or G % Hl == 0) else None
        if self.mdim is None:
            Hl = H
        self.Hl = Hl
        if cache is not None and is_dist(cache[0]):
            kv_split = self.mdim is not None and \
                self.mdim in sharded_dims(cache[0], 2)
        else:
            kv_split = self.mdim is not None and KH % m == 0
        self.kv_split = kv_split
        r = axis_coord(dmesh, "model") if self.mdim is not None else 0
        if kv_split or self.mdim is None:
            self.kv_sel = slice(None)
        else:
            self.kv_sel = slice(r * Hl // G, ((r + 1) * Hl - 1) // G + 1)

    def _pl(self, heads_split: bool):
        dims = {0: list(self.bdims)}
        if heads_split:
            dims[2] = [self.mdim]
        return placements(self.dmesh, dims)

    def q_placements(self):
        return self._pl(self.mdim is not None)

    def kv_placements(self):
        return self._pl(self.kv_split)

    def batch_placements(self):
        return self._pl(False)

    def kv_source(self, width: int):
        """Where gathered kv heads are gathered from: their columns
        (``width`` of them) split over ``model`` when they divide it, so
        the gradient flowing back is reduce-scattered onto them before
        the projection's backward, not multiplied whole on every rank."""
        m = self.dmesh.size(self.mdim)
        return self._pl(width % m == 0)


# --------------------------------------------------------- local regions ---
class Region(NamedTuple):
    """Where a block of a local region runs: the ``DeviceMesh``, the mesh
    dims the batch rows split over, and ``split``, the number of ``model``
    ranks that share the block's work (1: every rank runs all of it)."""
    dmesh: object
    bdims: tuple
    split: int

    @property
    def rank(self) -> int:
        """This rank's share of the block's work: its ``model``
        coordinate."""
        return axis_coord(self.dmesh, "model")


class Cut(NamedTuple):
    """The entries of a weight each ``model`` rank of a local region
    computes with: along ``dim``, row ``r`` of ``index`` (a (split, n)
    int array, each row increasing) for the rank of ``model`` coordinate
    ``r``."""
    dim: int
    index: np.ndarray


_PLANS: dict = {}


def _a2a_plan(cut: Cut, k: int, c: int, r: int) -> tuple:
    """How rank ``r`` cuts a weight split over ``model`` in blocks of
    ``c`` along dim ``k`` by ``cut``: (the indices into its shard along
    ``cut.dim`` that it sends, in rank order, the count it sends each
    rank, the count it receives from each, whether every rank's cut lies
    in its own shard).  Kept a ``cut`` (``ssm``'s cut builders return the
    same ones each call), so a step pays for it once."""
    key = (id(cut), k, c, r)
    if key not in _PLANS:
        m = len(cut.index)
        if k == cut.dim:
            def part(ix, s):
                return ix[(ix >= s * c) & (ix < (s + 1) * c)] - s * c
            sends = [part(ix, r) for ix in cut.index]
            recv = [len(part(cut.index[r], s)) for s in range(m)]
            own = all(len(part(ix, q)) == len(ix)
                      for q, ix in enumerate(cut.index))
        else:
            sends, own = list(cut.index), False
            recv = [cut.index.shape[1]] * m
        _PLANS[key] = (cut, np.concatenate(sends), [len(x) for x in sends],
                       recv, own)
    return _PLANS[key][1:]


_INDEX: dict = {}


def _index(ix: np.ndarray, t, key) -> torch.Tensor:
    """``ix`` as an index tensor on ``t``'s device, copied there once for
    ``key`` (a copy from pageable host memory waits for the stream, so a
    step that made one a weight would wait for the card hundreds of
    times); a fake ``t`` (a traced step) gets a fresh one."""
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(t):
        return torch.as_tensor(ix, dtype=torch.long, device=t.device)
    key = key + (t.device,)
    if key not in _INDEX:
        _INDEX[key] = torch.as_tensor(ix, dtype=torch.long, device=t.device)
    return _INDEX[key]


def _cut_weight(w, cut: Cut, dmesh, bdims):
    """This rank's entries of weight ``w`` (``cut.index[r]`` along
    ``cut.dim``, ``r`` its ``model`` coordinate), gathered over the other
    mesh dims, its gradient a partial sum over ``bdims``.  A weight split
    over ``model`` is cut by one all-to-all there: each rank sends every
    other the entries of its shard that that rank computes with, so a
    rank receives its share, never the whole weight, and the gradient
    goes back the same way, summed on the shard's owner.  A cut that
    stays in each rank's shard moves nothing.  A weight whole on every
    ``model`` rank is cut locally, its gradient summed over ``model``."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd)
    from torch.distributed.tensor import Replicate, Shard
    md = _names(dmesh).index("model")
    r = axis_coord(dmesh, "model")
    p = w.placements[md] if is_dist(w) else Replicate()
    pl = [Replicate()] * dmesh.ndim

    def take(t, ix, key):
        return t.index_select(cut.dim, _index(ix, t, key))
    if not isinstance(p, Shard):
        return take(local(w, dmesh, pl, tuple(bdims) + (md,)), cut.index[r],
                    (id(cut), r))
    pl[md] = p
    loc = local(w, dmesh, pl, bdims)
    k, c = p.dim, loc.shape[p.dim]
    send, n_send, n_recv, own = _a2a_plan(cut, k, c, r)
    if own and np.array_equal(send, np.arange(c)):
        return loc
    # each rank's piece is (entries, the other dims), cut.dim moved first
    buf = take(loc, send, (id(cut), k, c, r))
    if own:
        return buf
    buf = buf.movedim(cut.dim, 0)
    rest = tuple(buf.shape[1:])
    per = int(np.prod(rest))
    got = all_to_all_single_autograd(
        buf.reshape(-1), [n * per for n in n_recv],
        [n * per for n in n_send], dmesh.get_group(md))
    if k == cut.dim:
        # the pieces arrive in rank order along the cut dim itself
        return got.view((sum(n_recv),) + rest).movedim(0, k)
    # (rank, entries, the other dims): each rank's block goes before k's
    kk = k - (k > cut.dim)
    t = got.view((len(n_recv), n_recv[0]) + rest).movedim(0, 1 + kk)
    return t.flatten(1 + kk, 2 + kk).movedim(0, cut.dim)


def _cut_tree(w, cut, dmesh, bdims):
    """Each tensor leaf of ``w`` cut by its entry of the tree ``cut``
    (:func:`_cut_weight`), or, where that is None, gathered whole with its
    gradient summed over ``model`` (each rank computes on its share)."""
    from torch.distributed.tensor import Replicate
    if isinstance(w, dict):
        return {k: _cut_tree(v, None if cut is None else cut[k], dmesh,
                             bdims) for k, v in w.items()}
    if not isinstance(w, torch.Tensor):
        return w
    if cut is None:
        return local(w, dmesh, [Replicate()] * dmesh.ndim,
                     tuple(bdims) + (_names(dmesh).index("model"),))
    return _cut_weight(w, cut, dmesh, bdims)


def local_region(fn, dmesh, bdims, batched: Sequence, whole: Sequence,
                 states: Sequence = (), shared: Sequence = (),
                 split: int = 1, state_dims: Sequence = (),
                 cuts: Sequence = ()):
    """``fn(region, *batched, *whole, *shared, *states)`` on this rank's
    local tensors, ``region`` the :class:`Region` (``dmesh``, ``bdims``,
    ``split``): each of ``batched`` (DTensors or plain tensors, leading
    dim the batch) cut to the rank's batch rows over the mesh dims
    ``bdims``, each leaf of the trees in ``whole`` gathered, each tree of
    ``shared`` (one a block, which each ``model`` rank computes on its
    share of) cut by the matching tree of cuts in ``cuts`` (:class:`Cut`,
    :func:`_cut_tree`; no entry: every leaf whole), and each node of
    ``states`` (a NamedTuple of DTensors whose batch dim is 0, or None)
    cut like the batch and, with ``split`` > 1, leaf ``i`` over ``model``
    on its dim ``state_dims[j][i]`` (None, or a None entry: whole on every
    ``model`` rank).  A state leaf already so placed is the rank's shard
    itself, which ``fn`` writes in place; any other is redistributed in
    and written back.  ``fn`` returns one tensor of leading dim the
    batch, or a tuple whose first entry is one; that entry comes back a
    DTensor of the batch placement, the rest as they are."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.utils import tree_map
    rep = [Replicate()] * dmesh.ndim
    bpl = placements(dmesh, {0: list(bdims)})
    mdim = _names(dmesh).index("model") if split > 1 else None

    def want(d):
        if d is None or mdim is None:
            return bpl
        pl = list(bpl)
        pl[mdim] = Shard(d)
        return pl
    loc_b = [local(x, dmesh, bpl) for x in batched]
    loc_w = [tree_map(lambda t: local(t, dmesh, rep, bdims)
                      if isinstance(t, torch.Tensor) else t, w)
             for w in whole]
    loc_w += [_cut_tree(w, c, dmesh, bdims) for w, c in
              zip(shared, list(cuts) + [None] * len(shared))]
    state_pls = [None if st is None else
                 [want(d) for d in (ds or (None,) * len(st))]
                 for st, ds in zip(states, list(state_dims)
                                   + [None] * len(states))]
    loc_s = [None if st is None else
             type(st)(*[local(t, dmesh, pl) for t, pl in zip(st, pls)])
             for st, pls in zip(states, state_pls)]
    out = fn(Region(dmesh, tuple(bdims), split), *loc_b, *loc_w, *loc_s)
    for st, ls, pls in zip(states, loc_s, state_pls):
        if st is None:
            continue
        for dst, src, pl in zip(st, ls, pls):
            back = layout(wrap(src, dmesh, pl, dst.shape),
                          dst.placements).to_local()
            dl = dst.to_local()
            if back.data_ptr() != dl.data_ptr():
                dl.copy_(back)
    first = out[0] if isinstance(out, tuple) else out
    wrapped = wrap(first, dmesh, bpl,
                   (batched[0].shape[0],) + tuple(first.shape[1:]))
    return (wrapped,) + tuple(out[1:]) if isinstance(out, tuple) else wrapped


def _region_placements(region, partial: bool) -> list:
    """The batch placement of ``region``, partial over ``model`` or not."""
    from torch.distributed.tensor import Partial
    pl = placements(region.dmesh, {0: list(region.bdims)})
    if partial:
        pl[_names(region.dmesh).index("model")] = Partial()
    return pl


def _region_shape(t, region) -> tuple:
    n = t.shape[0]
    for d in region.bdims:
        n *= region.dmesh.size(d)
    return (n,) + tuple(t.shape[1:])


def region_grad_sum(t, region):
    """``t`` of the local region ``region``, unchanged; its gradient, of
    which each ``model`` rank computes a share, summed over ``model``."""
    if region is None:
        return t
    dmesh = region.dmesh
    pl = _region_placements(region, False)
    return local(wrap(t, dmesh, pl, _region_shape(t, region)), dmesh, pl,
                 (_names(dmesh).index("model"),))


def region_sum(t, region, grad_sum: bool = False):
    """``t`` of the local region ``region`` summed over ``model``.  Its
    gradient is the result's (every rank holds the same), or with
    ``grad_sum`` summed over ``model`` too (each rank holds a share)."""
    if region is None:
        return t
    pl = _region_placements(region, True)
    x = layout(wrap(t, region.dmesh, pl, _region_shape(t, region)),
               reduced(pl))
    return x.to_local(grad_placements=pl) if grad_sum else x.to_local()


def region_gather(t, region, dim: int):
    """``t`` of the local region ``region`` (leading dim the batch) whose
    dim ``dim`` each ``model`` rank holds a part of, gathered whole in
    rank order.  Its gradient, of which each rank computes a share, is
    summed over ``model`` and cut back to the rank's part (a
    reduce-scatter)."""
    if region is None:
        return t
    dmesh = region.dmesh
    shape = list(_region_shape(t, region))
    shape[dim] *= region.split
    pl = placements(dmesh, {0: list(region.bdims),
                            dim: [_names(dmesh).index("model")]})
    x = layout(wrap(t, dmesh, pl, shape), _region_placements(region, False))
    return x.to_local(grad_placements=_region_placements(region, True))


def region_rms_norm(scale, y, region, width: int, eps: float = 1e-6):
    """``layers.rms_norm`` over ``width`` features of which ``y`` holds
    this rank's in the local region ``region`` (``scale`` their entries):
    one sum over ``model`` of a value a row completes the sums of
    squares, its gradient summed back the same way."""
    return _rms_norm_of_part(scale, y, width, eps, lambda ss: region_sum(
        ss, region, grad_sum=True))
