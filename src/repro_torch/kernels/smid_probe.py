"""Binding of ``csrc/smid_probe.cu``: the id of the SM each block of a
launch ran on.

A check of where a GMI's work runs (``core/gmi.py``), not a kernel port:
it replaces no TPU kernel, so it has no plain version and no ``ops``
wrapper; ``chip_smoke.py`` launches it inside each GMI's green context.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.cache
def _lib():
    lib = _build.load("smid_probe")
    # a check with no plain version and no ops wrapper: it reports where
    # blocks ran, which no function of the inputs computes
    # repro: allow(kernel-oracle)
    lib.smid_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_void_p]
    lib.smid_probe_launch.restype = ctypes.c_int
    return lib


def smid_probe(blocks: int, spin: int, device) -> torch.Tensor:
    """The id of the SM each of ``blocks`` blocks ran on, each block
    spinning ``spin`` clock cycles first, on the current stream."""
    out = torch.full((blocks,), -1, dtype=torch.int32, device=device)
    err = _lib().smid_probe_launch(
        out.data_ptr(), blocks, spin,
        torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"smid_probe_kernel launch failed: CUDA error "
                           f"{err}")
    return out
