"""Binding of the CUDA fused GAE kernel (``csrc/gae_scan.cu``).

Replaces ``repro/kernels/gae_scan.py::gae_scan``: reverse GAE scan over T,
``returns = adv + v``, then mean/std normalisation of the advantages over
all T*N elements.  Call it through ``ops.gae_norm``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = _build.load("gae_scan")
    lib.gae_scan_launch.argtypes = [_P] * 7 + [_I, _I, _F, _F, _F, _P]
    lib.gae_scan_launch.restype = _I
    lib.gae_scan_scratch.argtypes = [_I]
    lib.gae_scan_scratch.restype = _I
    return lib


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
    scratch = torch.empty((lib.gae_scan_scratch(N),), dtype=torch.float32,
                          device=dev)
    err = lib.gae_scan_launch(
        rewards.data_ptr(), values.data_ptr(), dones.data_ptr(),
        last_value.data_ptr(), adv.data_ptr(), ret.data_ptr(),
        scratch.data_ptr(), T, N, gamma, gamma * lam, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gae_norm kernel launch failed: CUDA error {err}")
    return adv, ret
