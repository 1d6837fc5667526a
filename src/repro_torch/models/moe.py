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
  constrain buffers to a device mesh; on one device they do nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils import lecun_init


def set_moe_sharding(group_axis, model_axis="model"):
    """The reference's sharding hook (group_axis: the mesh axis the batch
    dim shards over; model_axis: the one the expert hidden dim shards
    over), kept with its signature.  One device has no mesh to shard
    over, so it does nothing."""


def _constrain(x, *tail):
    """The reference's sharding constraint; the identity on one device."""
    return x


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
              capacity_factor: float):
    """Capacity-bucketed dispatch over groups = leading dim.  x: (B, S, D),
    logits: (B, S, E) -> out (B, S, D)."""
    B, S, D = x.shape
    E, k = num_experts, top_k
    dt = x.dtype
    capacity = max(int(S * k / E * capacity_factor), k)

    slot, gate, valid = _route(logits, k, capacity, E)
    gate = gate.to(dt)
    flat_slot = slot.reshape(B, S * k)

    # scatter into each group's (E*capacity + 1) buffer
    xk = torch.repeat_interleave(x, k, dim=1)                  # (B,S*k,D)
    idx = flat_slot[..., None].expand(B, S * k, D)
    buf = torch.zeros((B, E * capacity + 1, D), dtype=dt, device=x.device)
    buf.scatter_add_(1, idx, xk)
    bufe = _constrain(buf[:, :-1].reshape(B, E, capacity, D), None, None,
                      None)

    h = torch.einsum("becd,edf->becf", bufe, params["wi"].to(dt))
    g = torch.einsum("becd,edf->becf", bufe, params["wg"].to(dt))
    h = _constrain(F.silu(g) * h, None, None, "model")
    out_buf = torch.einsum("becf,efd->becd", h, params["wo"].to(dt))

    out_flat = torch.cat([out_buf.reshape(B, E * capacity, D),
                          torch.zeros((B, 1, D), dtype=dt, device=x.device)],
                         dim=1)
    y = torch.gather(out_flat, 1, idx).reshape(B, S, k, D)
    w = (gate * valid.to(gate.dtype))[..., None]
    return torch.sum(y * w.to(y.dtype), dim=2)


def moe_apply(params, x, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, aux_coef: float = 0.01,
              route_block: int = 0):
    """x: (B, S, D) -> (out (B,S,D), aux_loss f32 scalar).

    Routing groups are batch rows.  With ``route_block`` R > 0 capacity
    competition is confined to R-token blocks within each row (the row is
    end-padded to a multiple of R; pads sit after real tokens, so they
    only take leftover capacity): routing is then the same whether a
    prompt is prefilled whole or in chunks that start at multiples of R.
    One decode token (S == 1) always gets its full top-k."""
    B, S, D = x.shape
    E = num_experts
    dt = x.dtype
    logits = x @ params["router"].to(dt)                       # (B,S,E)

    R = route_block
    if R and R > 0 and S > 1:
        nb = -(-S // R)
        pad = nb * R - S
        xg = F.pad(x, (0, 0, 0, pad)) if pad else x
        lg = F.pad(logits, (0, 0, 0, pad)) if pad else logits
        out = _dispatch(params, xg.reshape(B * nb, R, D),
                        lg.reshape(B * nb, R, E), E, top_k, capacity_factor)
        out = out.reshape(B, nb * R, D)[:, :S]
    else:
        out = _dispatch(params, x, logits, E, top_k, capacity_factor)

    # Switch-style load-balance auxiliary loss, on the unpadded logits
    probs = torch.softmax(logits.float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = torch.mean(F.one_hot(top1, E).float(), dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    aux = aux_coef * E * torch.sum(frac_tokens * frac_probs)
    return out, aux
