"""Ring buffers of the MCC experience pipeline and the binding of the CUDA
ring-pack kernel (``csrc/channel_pack.cu``); port of the experience half
of ``repro/kernels/channel_pack.py``.

Ring layout (S = ring slots, one slot per push), a public contract shared
with the env megakernel's ring writes:

    obs           (T, S*N, obs_dim)     slot s -> columns [s*N, (s+1)*N)
    actions       (T, S*N, act_dim)
    rewards       (T, S*N)
    dones         (T, S*N)
    bootstrap     (S, N)                slot s -> row s
    actor_version (S, 1) int32          slot s -> row s

:func:`launch` replaces ``channel_pack.py::pack_channels``: one launch
writes a push's six channels into slot ``slot`` in place; the slot is a
runtime argument.  Call it through ``ops.pack_channels``.  A payload's
``actor_version`` may be a Python int (passed to the kernel as a value,
with no host-to-device copy) or a one-element int32 tensor on the card.

:func:`pack_generation` is the overlap ring's bulk pack of its staged
pushes at a buffer swap; as in the reference it is plain tensor code
outside any kernel (``torch.cat``), and the consumer owns its output.

The cache-payload half (:func:`pack_cache_payload`,
:func:`unpack_cache_payload`, :func:`cache_payload_bytes`,
:func:`truncate_cache_pages`) is plain tensor code too, as the
reference's ``jnp.concatenate`` and ``dynamic_slice`` under ``jit`` are:
no Pallas kernel stands behind it.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten

CHANNELS = ("obs", "actions", "rewards", "dones", "bootstrap",
            "actor_version")

_P, _I = ctypes.c_void_p, ctypes.c_int


def version_tensor(v, device) -> torch.Tensor:
    """An actor version (Python int or tensor) as an int32 tensor on
    ``device``; a Python int becomes a fill, never a host-to-device copy."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32)
    return torch.full((), int(v), dtype=torch.int32, device=device)


def _as_payloads(payloads) -> Dict[str, torch.Tensor]:
    """Normalize payload ranks: bootstrap (N,) -> (1, N), version -> (1, 1)
    int32."""
    out = dict(payloads)
    out["bootstrap"] = payloads["bootstrap"].reshape(1, -1)
    out["actor_version"] = version_tensor(
        payloads["actor_version"], payloads["rewards"].device).reshape(1, 1)
    return out


def alloc_rings(payloads, slots: int) -> Dict[str, torch.Tensor]:
    """Zero-filled ring buffers sized for ``slots`` pushes shaped like
    ``payloads``, on the payloads' device (the layout above)."""
    T, N = payloads["rewards"].shape
    dev = payloads["rewards"].device

    def zeros(*shape, like):
        return torch.zeros(shape, dtype=like.dtype, device=dev)

    return {
        "obs": zeros(T, slots * N, *payloads["obs"].shape[2:],
                     like=payloads["obs"]),
        "actions": zeros(T, slots * N, *payloads["actions"].shape[2:],
                         like=payloads["actions"]),
        "rewards": zeros(T, slots * N, like=payloads["rewards"]),
        "dones": zeros(T, slots * N, like=payloads["dones"]),
        "bootstrap": zeros(slots, N, like=payloads["bootstrap"]),
        "actor_version": torch.zeros((slots, 1), dtype=torch.int32,
                                     device=dev),
    }


def pack_generation(staged) -> Dict[str, torch.Tensor]:
    """Pack a sequence of staged per-push payload dicts (oldest first) into
    one generation's channel arrays: slot ``s`` lands in the slot-aligned
    block of the ring layout; bootstrap and actor_version come back flat,
    (S*N,) and (S,)."""
    assert staged
    per = [_as_payloads(p) for p in staged]

    def cat(c, dim):
        xs = [p[c] for p in per]
        return xs[0] if len(xs) == 1 else torch.cat(xs, dim=dim)

    return {
        "obs": cat("obs", 1),
        "actions": cat("actions", 1),
        "rewards": cat("rewards", 1),
        "dones": cat("dones", 1),
        "bootstrap": cat("bootstrap", 0).reshape(-1),
        "actor_version": cat("actor_version", 0).reshape(-1),
    }


def _fn():
    f = _build.load("channel_pack").pack_channels_launch
    f.argtypes = [_P] * 6 + [_I] + [_P] * 6 + [_I] * 6 + [_P]
    f.restype = _I
    return f


def launch(bufs, payloads, slot):
    op = "pack_channels"
    T, N = payloads["rewards"].shape
    S = bufs["bootstrap"].shape[0]
    obs_dim = payloads["obs"].shape[-1]
    act_dim = payloads["actions"].shape[-1]
    if not 0 <= slot < S:
        raise ValueError(f"{op}: slot {slot} outside a ring of {S} slots")
    boot = payloads["bootstrap"].reshape(-1)
    for x, shape, nm in (
            (payloads["obs"], (T, N, obs_dim), "payloads['obs']"),
            (payloads["actions"], (T, N, act_dim), "payloads['actions']"),
            (payloads["rewards"], (T, N), "payloads['rewards']"),
            (payloads["dones"], (T, N), "payloads['dones']"),
            (boot, (N,), "payloads['bootstrap']"),
            (bufs["obs"], (T, S * N, obs_dim), "bufs['obs']"),
            (bufs["actions"], (T, S * N, act_dim), "bufs['actions']"),
            (bufs["rewards"], (T, S * N), "bufs['rewards']"),
            (bufs["dones"], (T, S * N), "bufs['dones']"),
            (bufs["bootstrap"], (S, N), "bufs['bootstrap']")):
        _build.check_tensor(op, nm, x, shape)
    _build.check_tensor(op, "bufs['actor_version']", bufs["actor_version"],
                        (S, 1), torch.int32)
    ver = payloads["actor_version"]
    if isinstance(ver, torch.Tensor):
        if ver.numel() != 1:
            raise ValueError(f"{op}: actor_version must hold one value, got "
                             f"shape {tuple(ver.shape)}")
        _build.check_tensor(op, "payloads['actor_version']", ver,
                            ver.shape, torch.int32)
        ver_ptr, ver_val = ver.data_ptr(), 0
    else:
        ver_ptr, ver_val = None, int(ver)
    dev = bufs["rewards"].device
    err = _fn()(
        *[payloads[c].data_ptr() for c in CHANNELS[:4]], boot.data_ptr(),
        ver_ptr, ver_val, *[bufs[c].data_ptr() for c in CHANNELS],
        T, N, S, obs_dim, act_dim, int(slot),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pack_channels kernel launch failed: CUDA error "
                           f"{err}")
    return bufs


# ----------------------------------------------------- cache-payload pack ---
# Prefill/decode disaggregation ships a finished prefill cache (a tree of
# KV stacks or recurrent states) between GMIs.  Shipping every leaf on its
# own is the fine-grained-transfer pathology the ring pack above exists to
# avoid, so a payload is flattened into ONE contiguous 1-D buffer per
# dtype, dtype-sorted by name and each in the reference's leaf order
# (``jax.tree.flatten``: dict keys sorted, named-tuple fields in order), so
# buffer order and sizes equal the reference's; one ``torch.cat`` per dtype
# packs it and slicing views of the buffers rebuild it bit-exactly.

def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _sorted(tree):
    """``tree`` with every dict rebuilt in sorted key order, so that
    flattening yields JAX's leaf order."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_sorted(x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_sorted(x) for x in tree)
    return tree


def pack_cache_payload(tree):
    """Flatten a cache tree into per-dtype contiguous 1-D buffers.

    Returns ``(bufs, meta)``: ``bufs`` is a tuple of tensors on the tree's
    device (one per distinct dtype, sorted by dtype name) and ``meta``
    rebuilds the tree through :func:`unpack_cache_payload`.  The round
    trip is bit-exact: no cast, a flatten and one concatenation a dtype.
    Runs on the current stream."""
    leaves, treedef = tree_flatten(_sorted(tree))
    spec = tuple((tuple(l.shape), _dtype_name(l.dtype)) for l in leaves)
    bufs = tuple(
        torch.cat([l.reshape(-1) for l, (_, d) in zip(leaves, spec)
                   if d == dt])
        for dt in sorted({d for _, d in spec}))
    return bufs, (treedef, spec)


def unpack_cache_payload(bufs, meta):
    """Inverse of :func:`pack_cache_payload`: every leaf a view of its
    dtype's buffer (no copy)."""
    treedef, spec = meta
    dtypes = sorted({d for _, d in spec})
    offs = {dt: 0 for dt in dtypes}
    leaves = []
    for shape, dt in spec:
        n = 1
        for s in shape:
            n *= s
        buf = bufs[dtypes.index(dt)]
        leaves.append(buf[offs[dt]:offs[dt] + n].view(shape))
        offs[dt] += n
    return tree_unflatten(leaves, treedef)


def cache_payload_bytes(bufs) -> int:
    """Wire size of a packed payload (sum over per-dtype buffers)."""
    return int(sum(b.numel() * b.element_size() for b in bufs))


# ----------------------------------------------- page-wise payload pruning ---
def _is_kv(node) -> bool:
    return hasattr(node, "slot_pos") and hasattr(node, "k")


def truncate_cache_pages(tree, used_tokens: int, page_size: int,
                         head_skip: int = 0):
    """Prune a B=1 prefill-cache payload to whole pages before migration.

    Full-depth attention nodes (duck-typed: a ``slot_pos`` and a ``k``,
    whose sequence axis 2 covers every written position) are sliced along
    it to ``[head_skip*page_size, ceil(used_tokens/page_size)*page_size)``:
    the max_seq tail a monolithic payload would ship goes, and so do the
    leading ``head_skip`` pages the destination already holds in its
    shared-prefix index.  The decode engine's paged splice scatters
    entries by their recorded ``slot_pos``, so pruning is position-safe.
    Ring-buffer (sliding window) nodes shorter than ``used_tokens`` and
    recurrent states ship whole.  The slices are views."""
    P = max(int(page_size), 1)
    hi = -(-max(int(used_tokens), 0) // P) * P
    lo = min(max(int(head_skip), 0) * P, hi)

    def prune(n):
        if not _is_kv(n):
            return n
        S = n.k.shape[2]
        if S < used_tokens:      # ring buffer: indices are not positions
            return n
        h = min(hi, S)
        return type(n)(n.k[:, :, lo:h], n.v[:, :, lo:h],
                       n.slot_pos[:, :, lo:h])

    return tree_map(prune, tree, is_leaf=_is_kv)
