"""Binding of the CUDA kernel in ``csrc/mlstm_chunkwise.cu``.

:func:`launch` replaces ``repro/kernels/mlstm_scan.py::mlstm_chunkwise``:
chunkwise mLSTM, log-gated masked linear attention inside each chunk and
the (C, n, m) state carried across chunks.  Unlike the TPU kernel it starts
from a given state and returns the final one, which chunked prefill and
decode need.  Call it through ``ops.mlstm_chunkwise``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("mlstm_chunkwise")
    lib.mlstm_chunkwise_launch.argtypes = [_P] * 23 + [_I] * 4 + [_P]
    lib.mlstm_chunkwise_launch.restype = _I
    return lib


def launch(q, k, v, log_i, log_f, C0, n0, m0, *, chunk: int):
    B, H, S, dh = q.shape
    L = min(int(chunk), S)
    for x, shape, nm in ((q, (B, H, S, dh), "q"), (k, (B, H, S, dh), "k"),
                         (v, (B, H, S, dh), "v"), (log_i, (B, H, S), "log_i"),
                         (log_f, (B, H, S), "log_f"),
                         (C0, (B, H, dh, dh), "C0"), (n0, (B, H, dh), "n0"),
                         (m0, (B, H), "m0")):
        _build.check_tensor("mlstm_chunkwise", nm, x, shape)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    if dh % 32 or not 32 <= dh <= 512:
        raise ValueError(f"mlstm_chunkwise: head dim {dh} not supported "
                         "(a multiple of 32, at most 512)")
    if any(x.data_ptr() % 16 for x in (q, k, v, C0)):
        raise ValueError("mlstm_chunkwise: q, k, v and C0 must be 16-byte "
                         "aligned")
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    h = torch.empty((B, H, S, dh), **f32)
    C = torch.empty((B, H, dh, dh), **f32)
    n = torch.empty((B, H, dh), **f32)
    m = torch.empty((B, H), **f32)
    # scratch: P (B*H, S, L); the state before each chunk after the first
    # (B*H, S/L - 1, dh, dh); n before each chunk (B*H, S/L, dh); six
    # per-step and two per-chunk vectors
    nc = S // L
    P = torch.empty((B * H, S, L), **f32)
    Cst = torch.empty((max(1, B * H * (nc - 1)), dh, dh), **f32)
    nst = torch.empty((B * H, nc, dh), **f32)
    steps = torch.empty((6, B * H, S), **f32)
    chunks = torch.empty((2, B * H, nc), **f32)
    err = _lib().mlstm_chunkwise_launch(
        *(t.data_ptr() for t in (q, k, v, log_i, log_f, C0, n0, m0, h, C, n,
                                 m, P, Cst, nst, *steps, *chunks)),
        B * H, S, L, dh, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunkwise kernel launch failed: CUDA "
                           f"error {err}")
    return h, C, n, m
