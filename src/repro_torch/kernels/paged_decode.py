"""Binding of the CUDA kernel in ``csrc/paged_decode.cu``.

:func:`launch` replaces ``repro/kernels/paged_decode.py::
paged_decode_attention``: one decode token per batch row attending over
the keys and values its page table maps, GQA groups, softcap and a runtime
sliding window; unmapped pages and empty page slots are masked, and a row
with no visible key (an idle slot at position -1) gives 0.  The kernel
splits each row's pages over several blocks (split-KV) and merges their
partials in the same launch: a per-call scratch holds the partials, and
per-stream tickets, 0 between calls, find each pair's last split.  Call
it through ``ops.paged_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BIG_WINDOW = 1 << 30
MAX_HD = 256
# the split kernel's tickets, one int32 a (row, kv head), per (device,
# stream): calls on one stream run in order, and each leaves its tickets
# at 0 (the last split of each pair sets its ticket back)
_TICKETS: dict = {}


def _lib():
    lib = _build.load("paged_decode")
    lib.paged_decode_launch.argtypes = [_P] * 10 + [_I] * 8 + \
        [_F, _F, _I, _P]
    lib.paged_decode_launch.restype = _I
    return lib


def num_splits(B: int, KH: int, P: int, M: int, sms: int) -> int:
    """Splits of each row's pages: at most two blocks an SM (one wave at
    the kernel's occupancy; a second wave costs more than the shorter
    splits save), and no split shorter than 32 key slots of the table's
    width."""
    want = 2 * sms // (B * KH)
    return max(1, min(want, -(-M * P // 32), 32))


def _tickets(dev, stream: int, n: int):
    t = _TICKETS.get((dev, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[(dev, stream)] = torch.zeros(max(n, 256),
                                                   dtype=torch.int32,
                                                   device=dev)
    return t


def launch(q, k_pages, v_pages, slot_pos, table, positions, *, window=None,
           softcap=None, scale=None):
    B, H, hd = q.shape
    N, P, KH, _ = k_pages.shape
    M = table.shape[1]
    dt = q.dtype
    if dt not in _DTYPES:
        raise ValueError(f"paged_attention: dtype {dt} not supported")
    for x, shape, nm, t in ((q, (B, H, hd), "q", dt),
                            (k_pages, (N, P, KH, hd), "k_pages", dt),
                            (v_pages, (N, P, KH, hd), "v_pages", dt),
                            (slot_pos, (N, P), "slot_pos", torch.int32),
                            (table, (B, M), "table", torch.int32),
                            (positions, (B,), "positions", torch.int32)):
        _build.check_tensor("paged_attention", nm, x, shape, t)
    vec = 16 // q.element_size()
    if H % KH or H // KH not in (1, 2, 4, 8) or hd % vec or hd > MAX_HD:
        raise ValueError(f"paged_attention: H={H}, KH={KH}, hd={hd} not "
                         "supported (H/KH in 1,2,4,8; hd a multiple of "
                         f"{vec} up to {MAX_HD})")
    if any(x.data_ptr() % 16 for x in (q, k_pages, v_pages)):
        raise ValueError("paged_attention: operands must be 16-byte aligned")
    win = BIG_WINDOW if window is None else int(window)
    dev = q.device
    nsplit = num_splits(B, KH, P, M, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = torch.empty_like(q)
    # partials of each split: acc, then (m, l)
    part = torch.empty(B * H * nsplit * (hd + 2), dtype=torch.float32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _tickets(dev, stream, B * KH)
    lib = _lib()
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        slot_pos.data_ptr(), table.data_ptr(), positions.data_ptr(),
        out.data_ptr(), part.data_ptr(),
        part.data_ptr() + 4 * B * H * nsplit * hd, tickets.data_ptr(),
        B, H, KH, hd, P, M, win, nsplit,
        hd ** -0.5 if scale is None else float(scale),
        0.0 if softcap is None else float(softcap), _DTYPES[dt], stream)
    if err != 0:
        # a launch that failed may have left tickets taken
        tickets.zero_()
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
