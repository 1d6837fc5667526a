"""Mixture-of-Experts layer: top-k router and capacity-bucketed dispatch
(port of ``repro/models/moe.py``).

Dispatch is grouped: tokens are routed within their batch row (or within
``route_block``-token blocks of it).  Each group scatters its tokens into a
flat ``(E * capacity + 1)`` buffer, one slot a kept (token, expert)
assignment, the last row collecting every assignment dropped by capacity;
the experts run as batched matrix products over the ``(E, capacity)``
buffer, and each token gathers its k outputs back and mixes them by gate.
The reference computes these products outside any Pallas kernel, so they
stay ``torch.einsum`` here.

Where the port differs in form, not in result:

* ``jax.lax.top_k`` puts the lower expert index first on a tie, and
  ``torch.topk`` promises no order, so the top k come from a stable
  descending sort, which keeps tied experts in index order.
* ``.at[].add`` becomes ``scatter_add_``: every kept slot is written
  once, so only the discarded drop row depends on the order of the adds.
* The reference's sharding hooks (``set_moe_sharding``, ``_constrain``)
  constrain the buffers of a sharded step: on DTensors the routing, the
  scatter into the dispatch buffer and the gather back run on each rank's
  groups (its batch rows over the group axis), and the expert products
  run on DTensors redistributed at the reference's five constraint sites.
  Plain tensors pass the hooks unchanged.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.utils import lecun_init


# sharding hook (set by a sharded step, like
# transformer.set_activation_sharding)
_GROUP_AXIS = None
_MODEL_AXIS = None


def set_moe_sharding(group_axis, model_axis="model"):
    """group_axis: mesh axis (or tuple) the batch/group dim shards over;
    model_axis: the axis the expert hidden dim (F) shards over."""
    global _GROUP_AXIS, _MODEL_AXIS
    _GROUP_AXIS = group_axis
    _MODEL_AXIS = model_axis if group_axis is not None else None


@contextlib.contextmanager
def moe_sharding(group_axis, model_axis="model"):
    """``set_moe_sharding`` for the body, the old hook after."""
    old = (_GROUP_AXIS, _MODEL_AXIS)
    set_moe_sharding(group_axis, model_axis)
    try:
        yield
    finally:
        set_moe_sharding(*old)


def _constrain(x, *tail):
    """tail entries: None or "model" (the configured model axis).  As in
    the reference the spec is total: a None dim is replicated.  A plain
    tensor, or no hook set, passes unchanged."""
    from repro_torch.dist import spmd
    if _GROUP_AXIS is None or not spmd.is_dist(x):
        return x
    spec = [_GROUP_AXIS] + [(_MODEL_AXIS if t == "model" else t)
                            for t in tail[:x.ndim - 1]]
    return spmd.constrain(x, spec)


def _group_placements(x):
    """Placements of (B, ...) DTensor ``x`` with the groups over the hook's
    group axis (when set and dividing B), everything else replicated."""
    from repro_torch.dist import spmd
    dm = x.device_mesh
    axes = () if _GROUP_AXIS is None else (
        _GROUP_AXIS if isinstance(_GROUP_AXIS, tuple) else (_GROUP_AXIS,))
    return spmd.placements(dm, {0: list(spmd.batch_dims(dm, x.shape[0],
                                                        axes))})


def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int):
    return {
        "router": lecun_init(gen, (d_model, num_experts)),
        "wi": lecun_init(gen, (num_experts, d_model, d_ff), fan_in=d_model),
        "wg": lecun_init(gen, (num_experts, d_model, d_ff), fan_in=d_model),
        "wo": lecun_init(gen, (num_experts, d_ff, d_model), fan_in=d_ff),
    }


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last dim, ties broken
    by the lower index first, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits, top_k: int, capacity: int, num_experts: int):
    """Routing of every group at once.  logits: (G, S, E).

    Returns (slot (G,S,k) int64, gate (G,S,k) f32, valid (G,S,k)); slot
    indexes a group's flat (E*capacity) dispatch buffer, and a dropped
    assignment points at the extra row E*capacity."""
    G, S, _ = logits.shape
    gate_all = torch.softmax(logits.float(), dim=-1)
    gate, expert = _top_k(gate_all, top_k)                     # (G,S,k)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    # flatten in token-major order: earlier tokens win capacity slots
    flat_e = expert.reshape(G, S * top_k)
    onehot = F.one_hot(flat_e, num_experts)
    pos = torch.cumsum(onehot, dim=1) - 1                      # (G,S*k,E)
    pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    valid = pos < capacity
    slot = torch.where(valid, flat_e * capacity + pos,
                       num_experts * capacity)
    return (slot.reshape(G, S, top_k), gate, valid.reshape(G, S, top_k))


def _route_group(x, logits, top_k: int, capacity: int, num_experts: int):
    """Per-group routing.  x: (S, D); logits: (S, E).

    Returns (slot (S,k), gate (S,k) in x's type, valid (S,k)) where slot
    indexes a flat (E*capacity) dispatch buffer."""
    slot, gate, valid = _route(logits[None], top_k, capacity, num_experts)
    return slot[0], gate[0].to(x.dtype), valid[0]


def _dispatch(params, x, logits, num_experts: int, top_k: int,
              capacity_factor: float, experts=None):
    """Capacity-bucketed dispatch over groups = leading dim.  x: (G, S, D),
    logits: (G, S, E) -> out (G, S, D).  ``experts(params, buf)`` maps the
    (G, E, capacity, D) dispatch buffer to the experts' outputs of that
    shape (:func:`_experts` when None)."""
    G, S, D = x.shape
    E, k = num_experts, top_k
    dt = x.dtype
    capacity = max(int(S * k / E * capacity_factor), k)

    slot, gate, valid = _route(logits, k, capacity, E)
    gate = gate.to(dt)
    flat_slot = slot.reshape(G, S * k)

    # scatter into each group's (E*capacity + 1) buffer
    xk = torch.repeat_interleave(x, k, dim=1)                  # (G,S*k,D)
    idx = flat_slot[..., None].expand(G, S * k, D)
    buf = torch.zeros((G, E * capacity + 1, D), dtype=dt, device=x.device)
    buf.scatter_add_(1, idx, xk)
    out_buf = (experts or _experts)(
        params, buf[:, :-1].reshape(G, E, capacity, D))
    return _combine(out_buf.reshape(G, E * capacity, D), idx, gate, valid,
                    S, k)


def _combine(out_flat, idx, gate, valid, S: int, k: int):
    """Each token's k expert outputs gathered from the flat buffer (the
    drop row reads zeros) and mixed by gate."""
    B, _, D = out_flat.shape
    out_flat = torch.cat([out_flat, torch.zeros((B, 1, D), dtype=out_flat.dtype,
                                                device=out_flat.device)],
                         dim=1)
    y = torch.gather(out_flat, 1, idx).reshape(B, S, k, D)
    w = (gate * valid.to(gate.dtype))[..., None]
    return torch.sum(y * w.to(y.dtype), dim=2)


def _experts(params, buf):
    """The experts' SwiGLU over a (G, E, capacity, D) dispatch buffer."""
    dt = buf.dtype
    h = torch.einsum("becd,edf->becf", buf, params["wi"].to(dt))
    g = torch.einsum("becd,edf->becf", buf, params["wg"].to(dt))
    return torch.einsum("becf,efd->becd", F.silu(g) * h,
                        params["wo"].to(dt))


def _sharded_experts(dm, gpl):
    """:func:`_experts` for a rank's local (Gl, E, capacity, D) buffer,
    its groups placed by ``gpl`` on ``dm``: the products run on DTensors,
    each expert's buffer laid out (E, groups * capacity, D) so that no
    DTensor is reshaped or permuted, redistributed at the reference's
    constraint sites (groups over the group axis, the expert hidden dim
    over ``model``)."""
    from repro_torch.dist import spmd
    gdims = spmd.sharded_dims_of(gpl, 0)
    epl = spmd.placements(dm, {1: list(gdims)})

    def run(params, buf):
        Gl, E, C, D = buf.shape
        dt = buf.dtype
        G = Gl
        for d in gdims:
            G *= dm.size(d)

        def at(t, *tail):
            return spmd.constrain(t, (None, _GROUP_AXIS) + tail)
        flat = buf.transpose(0, 1).reshape(E, Gl * C, D)
        b = at(spmd.wrap(flat, dm, epl, (E, G * C, D)), None)
        h = torch.bmm(b, params["wi"].to(dt))
        g = torch.bmm(b, params["wg"].to(dt))
        h = at(F.silu(g) * h, _MODEL_AXIS)
        out = at(torch.bmm(h, params["wo"].to(dt)), None)
        return spmd.local(out, dm, epl).reshape(E, Gl, C, D).transpose(0, 1)
    return run


def moe_apply(params, x, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, aux_coef: float = 0.01,
              route_block: int = 0):
    """x: (B, S, D) -> (out (B,S,D), aux_loss f32 scalar).

    Routing groups are batch rows.  With ``route_block`` R > 0 capacity
    competition is confined to R-token blocks within each row (the row is
    end-padded to a multiple of R; pads sit after real tokens, so they
    only take leftover capacity): routing is then the same whether a
    prompt is prefilled whole or in chunks that start at multiples of R.
    One decode token (S == 1) always gets its full top-k.

    On DTensors each rank routes its own groups' rows (the group axis of
    the hook) on local tensors, so no DTensor is padded or reshaped; only
    the expert products (:func:`_sharded_experts`) and the load-balance
    loss's sums over the groups cross ranks."""
    from repro_torch.dist import spmd
    B, S, D = x.shape
    E = num_experts
    dt = x.dtype
    logits = x @ params["router"].to(dt)                       # (B,S,E)
    experts = None
    if spmd.is_dist(x):
        dm, gpl = x.device_mesh, _group_placements(x)
        experts = _sharded_experts(dm, gpl)
        x, logits = spmd.local(x, dm, gpl), spmd.local(logits, dm, gpl)
    Bl = x.shape[0]

    R = route_block
    if R and R > 0 and S > 1:
        nb = -(-S // R)
        pad = nb * R - S
        xg = F.pad(x, (0, 0, 0, pad)) if pad else x
        lg = F.pad(logits, (0, 0, 0, pad)) if pad else logits
        out = _dispatch(params, xg.reshape(Bl * nb, R, D),
                        lg.reshape(Bl * nb, R, E), E, top_k, capacity_factor,
                        experts)
        out = out.reshape(Bl, nb * R, D)[:, :S]
    else:
        out = _dispatch(params, x, logits, E, top_k, capacity_factor,
                        experts)

    # Switch-style load-balance auxiliary loss, on the unpadded logits:
    # the top-1 counts and the probabilities summed over this rank's
    # groups, then over the group axis
    probs = torch.softmax(logits.float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    sums = torch.stack([F.one_hot(top1, E).float().sum(dim=(0, 1)),
                        probs.sum(dim=(0, 1))])
    if experts is not None:
        out = _constrain(spmd.wrap(out, dm, gpl, (B, S, D)), None, None)
        sums = _group_sum(sums, dm, gpl)
    n = B * S
    aux = aux_coef * E * torch.sum((sums[0] / n) * (sums[1] / n))
    return out, aux


def _group_sum(sums, dm, gpl):
    """A rank's (2, E) sums over its groups, summed over the group axis
    (a replicated DTensor)."""
    from torch.distributed.tensor import Partial
    from repro_torch.dist import spmd
    pl = [Partial() if p.is_shard() else p for p in gpl]
    return spmd.layout(spmd.wrap(sums, dm, pl, tuple(sums.shape)),
                       spmd.reduced(pl))
