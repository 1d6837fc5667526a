"""Binding of the CUDA env megakernel (``csrc/env_megakernel.cu``).

The kernel replaces ``repro/kernels/env_megakernel.py::env_mega_step``: one
launch advances every env by one policy step (substeps, reward, bookkeeping,
predicated counter-PRNG reset, observation) and, when ring buffers are
given, writes the acted-on obs, raw action, reward and done into ring row
``step_t``, columns ``[slot*N, (slot+1)*N)``, in place.  Call it through
``ops.env_mega_step``, which dispatches on the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_JOINTS = 21
MAX_OBS = 256
_RING_KEYS = ("obs", "actions", "rewards", "dones")

_P, _I = ctypes.c_void_p, ctypes.c_int


def bind(lib):
    """The launch function of a library built from
    ``csrc/env_megakernel.cu``, with its argument types."""
    f = lib.env_mega_step_launch
    f.argtypes = [_P] * 25 + [_I] * 8 + [_P, _P]
    f.restype = _I
    return f


@functools.cache
def _fn():
    return bind(_build.load("env_megakernel"))


@functools.cache
def _consts(chain, task, h):
    return (ctypes.c_float * 14)(*chain, *task, h)


def _check(x, shape, dtype, name):
    _build.check_tensor("env_mega_step", name, x, shape, dtype)


def launch(q, qd, root, prev_action, t, seed, resets, action, obs, bufs,
           step_t, slot, sensor, tgt, masses, lengths, *, chain, task,
           substeps, dt, max_episode_len):
    N, J = q.shape
    R, obs_dim = sensor.shape
    if not 1 <= J <= MAX_JOINTS or R != 6 + 4 * J + 3 \
            or not 1 <= obs_dim <= MAX_OBS:
        raise ValueError(f"env_mega_step: J={J} (<= {MAX_JOINTS}), sensor "
                         f"rows {R} (== 6+4J+3) and obs_dim={obs_dim} (<= "
                         f"{MAX_OBS}) required")
    f32, i32 = torch.float32, torch.int32
    for x, shape, dt_, nm in (
            (q, (N, J), f32, "q"), (qd, (N, J), f32, "qd"),
            (root, (N, 6), f32, "root"), (prev_action, (N, J), f32,
                                            "prev_action"),
            (t, (N,), i32, "t"), (seed, (N,), i32, "seed"),
            (resets, (N,), i32, "resets"), (action, (N, J), f32, "action"),
            (sensor, (R, obs_dim), f32, "sensor"), (tgt, (J,), f32, "tgt"),
            (masses, (J,), f32, "masses"), (lengths, (J,), f32, "lengths")):
        _check(x, shape, dt_, nm)
    ring = [None] * 4
    ring_cols = 0
    if bufs is not None:
        T, ring_cols = bufs["rewards"].shape
        if not (0 <= step_t < T and 0 <= slot and (slot + 1) * N <= ring_cols):
            raise ValueError(f"env_mega_step: step_t={step_t}, slot={slot} "
                             f"outside ring (T={T}, columns={ring_cols})")
        _check(obs, (N, obs_dim), f32, "obs")
        for k, shape in zip(_RING_KEYS, ((T, ring_cols, obs_dim),
                                         (T, ring_cols, J), (T, ring_cols),
                                         (T, ring_cols))):
            _check(bufs[k], shape, f32, f"bufs[{k!r}]")
        ring = [bufs[k].data_ptr() for k in _RING_KEYS]
    dev = q.device
    q_o = torch.empty((N, J), dtype=f32, device=dev)
    qd_o = torch.empty_like(q_o)
    pa_o = torch.empty_like(q_o)
    root_o = torch.empty((N, 6), dtype=f32, device=dev)
    t_o = torch.empty((N,), dtype=i32, device=dev)
    resets_o = torch.empty_like(t_o)
    obs_o = torch.empty((N, obs_dim), dtype=f32, device=dev)
    rew_o = torch.empty((N,), dtype=f32, device=dev)
    done_o = torch.empty_like(rew_o)
    err = _fn()(
        q.data_ptr(), qd.data_ptr(), root.data_ptr(), t.data_ptr(),
        seed.data_ptr(), resets.data_ptr(), action.data_ptr(),
        obs.data_ptr() if bufs is not None else None, sensor.data_ptr(),
        tgt.data_ptr(), masses.data_ptr(), lengths.data_ptr(),
        q_o.data_ptr(), qd_o.data_ptr(), root_o.data_ptr(), pa_o.data_ptr(),
        t_o.data_ptr(), resets_o.data_ptr(), obs_o.data_ptr(),
        rew_o.data_ptr(), done_o.data_ptr(), *ring,
        N, J, obs_dim, ring_cols, int(step_t), int(slot), int(substeps),
        int(max_episode_len),
        _consts(tuple(chain), tuple(task), dt / substeps),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"env_mega_step kernel launch failed: CUDA error "
                           f"{err}")
    return (q_o, qd_o, root_o, pa_o, t_o, seed, resets_o, obs_o, rew_o,
            done_o, bufs)
