"""Bindings of the CUDA kernels in ``csrc/gae_scan.cu``.

:func:`launch` replaces ``repro/kernels/gae_scan.py::gae_scan``: reverse
GAE scan over T, ``returns = adv + v``, then mean/std normalisation of the
advantages over all T*N elements, in one cooperative launch.  Its
per-block partial sums live in a scratch kept per (device, stream): calls
on one stream run in order, so one scratch serves them all.  Call it
through ``ops.gae_norm``.

:func:`launch_nstep` replaces ``gae_scan.py::nstep_scan``, the A3C reverse
scan ``G_t = r_t + gamma * G_{t+1} * (1 - d_t)`` from the bootstrap value.
Call it through ``ops.nstep_returns``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the GAE kernel's partial sums, one scratch per (device, stream)
_SCRATCH: dict = {}


@functools.cache
def _lib():
    lib = _build.load("gae_scan")
    lib.gae_scan_launch.argtypes = [_P] * 7 + [_I, _I, _F, _F, _F, _P]
    lib.gae_scan_launch.restype = _I
    lib.gae_scan_scratch.argtypes = []
    lib.gae_scan_scratch.restype = _I
    lib.nstep_scan_launch.argtypes = [_P] * 4 + [_I, _I, _F, _P]
    lib.nstep_scan_launch.restype = _I
    return lib


def _scratch(lib, dev, stream: int):
    t = _SCRATCH.get((dev, stream))
    if t is None:
        n = lib.gae_scan_scratch()
        if n < 0:
            raise RuntimeError("gae_norm: occupancy query failed")
        t = _SCRATCH[(dev, stream)] = torch.empty((n,), dtype=torch.float32,
                                                   device=dev)
    return t


def launch(rewards, values, dones, last_value, *, gamma, lam, eps):
    T, N = rewards.shape
    for x, shape, nm in ((rewards, (T, N), "rewards"),
                         (values, (T, N), "values"), (dones, (T, N), "dones"),
                         (last_value, (N,), "last_value")):
        _build.check_tensor("gae_norm", nm, x, shape)
    lib = _lib()
    dev = rewards.device
    adv = torch.empty((T, N), dtype=torch.float32, device=dev)
    ret = torch.empty_like(adv)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gae_scan_launch(
        rewards.data_ptr(), values.data_ptr(), dones.data_ptr(),
        last_value.data_ptr(), adv.data_ptr(), ret.data_ptr(),
        _scratch(lib, dev, stream).data_ptr(), T, N, gamma, gamma * lam, eps,
        stream)
    if err != 0:
        raise RuntimeError(f"gae_norm kernel launch failed: CUDA error {err}")
    return adv, ret


def launch_nstep(rewards, dones, bootstrap, *, gamma):
    T, N = rewards.shape
    for x, shape, nm in ((rewards, (T, N), "rewards"),
                         (dones, (T, N), "dones"),
                         (bootstrap, (N,), "bootstrap")):
        _build.check_tensor("nstep_returns", nm, x, shape)
    lib = _lib()
    dev = rewards.device
    ret = torch.empty((T, N), dtype=torch.float32, device=dev)
    err = lib.nstep_scan_launch(
        rewards.data_ptr(), dones.data_ptr(), bootstrap.data_ptr(),
        ret.data_ptr(), T, N, gamma,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nstep_returns kernel launch failed: CUDA error "
                           f"{err}")
    return ret
