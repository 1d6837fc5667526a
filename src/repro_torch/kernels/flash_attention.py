"""Binding of the CUDA kernel in ``csrc/flash_attention.cu``.

:func:`launch` replaces ``repro/kernels/flash_attention.py::
flash_attention``: blocked online-softmax attention with GQA, an
index-based causal / sliding-window mask (query i and key j at positions i
and j) and a logit softcap.  The library routes by dtype: bf16 runs the
tensor-core kernel, f32 the fp32 kernel.  Call it through
``ops.flash_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BIG_WINDOW = 1 << 30
# the head dims the kernels are built for (bf16 pads 80 and 112 to 128, and
# 160 to 192, for the MMAs)
HEAD_DIMS = (64, 80, 112, 128, 160)


def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [_P] * 4 + [_I] * 8 + \
        [_F, _F, _I, _P]
    lib.flash_attention_launch.restype = _I
    return lib


def launch(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    dt = q.dtype
    if dt not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {dt} not supported")
    for x, shape, nm in ((q, (B, Sq, H, hd), "q"), (k, (B, Skv, KH, hd), "k"),
                         (v, (B, Skv, KH, hd), "v")):
        _build.check_tensor("flash_attention", nm, x, shape, dt)
    if hd not in HEAD_DIMS or H % KH:
        raise ValueError(f"flash_attention: hd={hd}, H={H}, KH={KH} not "
                         f"supported (hd in {HEAD_DIMS}, H a multiple of KH)")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: operands must be 16-byte aligned")
    win = BIG_WINDOW if window is None else int(window)
    # scale and softcap are Python numbers here, not device values
    # repro: allow(host-sync-in-hot-path)
    scale = hd ** -0.5 if scale is None else float(scale)
    # repro: allow(host-sync-in-hot-path)
    softcap = 0.0 if softcap is None else float(softcap)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, KH, hd, int(bool(causal)), win,
        scale, softcap, _DTYPES[dt],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
