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
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build

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
