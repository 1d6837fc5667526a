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
    lib.mlstm_chunkwise_launch.argtypes = [_P] * 23 + [_I] * 5 + [_P]
    lib.mlstm_chunkwise_launch.restype = _I
    return lib


def buffers(B, H, S, dk, L, dev, dv=None):
    """What a call allocates, with ``dv`` value rows (``dk`` when None):
    the outputs h (B, H, S, dv), C (B, H, dv, dk), n, m, then the scratch:
    P (B*H, S, L); the state before each chunk after the first (B*H, S/L -
    1, dv, dk); n before each chunk (B*H, S/L, dk); six per-step and two
    per-chunk vectors."""
    dv = dk if dv is None else dv
    f32 = dict(dtype=torch.float32, device=dev)
    nc = S // L
    return (torch.empty((B, H, S, dv), **f32),
            torch.empty((B, H, dv, dk), **f32),
            torch.empty((B, H, dk), **f32), torch.empty((B, H), **f32),
            torch.empty((B * H, S, L), **f32),
            torch.empty((max(1, B * H * (nc - 1)), dv, dk), **f32),
            torch.empty((B * H, nc, dk), **f32),
            torch.empty((6, B * H, S), **f32),
            torch.empty((2, B * H, nc), **f32))


def check_widths(dk: int, dv: int):
    """The widths the kernel takes: dk and dv multiples of 32 with
    32 <= dv <= dk <= 512 (dv < dk: a rank's share of every head's value
    rows).  Raises ValueError for any other."""
    if dk % 32 or dv % 32 or not 32 <= dv <= dk <= 512:
        raise ValueError(f"mlstm_chunkwise: key dim {dk} and value dim {dv} "
                         "not supported (multiples of 32 with 32 <= dv <= "
                         "dk <= 512)")


def launch(q, k, v, log_i, log_f, C0, n0, m0, *, chunk: int):
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    L = min(int(chunk), S)
    for x, shape, nm in ((q, (B, H, S, dk), "q"), (k, (B, H, S, dk), "k"),
                         (v, (B, H, S, dv), "v"), (log_i, (B, H, S), "log_i"),
                         (log_f, (B, H, S), "log_f"),
                         (C0, (B, H, dv, dk), "C0"), (n0, (B, H, dk), "n0"),
                         (m0, (B, H), "m0")):
        _build.check_tensor("mlstm_chunkwise", nm, x, shape)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    check_widths(dk, dv)
    if any(x.data_ptr() % 16 for x in (q, k, v, C0)):
        raise ValueError("mlstm_chunkwise: q, k, v and C0 must be 16-byte "
                         "aligned")
    h, C, n, m, P, Cst, nst, steps, chunks = buffers(B, H, S, dk, L,
                                                     q.device, dv)
    err = _lib().mlstm_chunkwise_launch(
        *(t.data_ptr() for t in (q, k, v, log_i, log_f, C0, n0, m0, h, C, n,
                                 m, P, Cst, nst, *steps, *chunks)),
        B * H, S, L, dk, dv, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunkwise kernel launch failed: CUDA "
                           f"error {err}")
    return h, C, n, m
