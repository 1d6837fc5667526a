"""Bindings of ``csrc/sm_partition.cu``: the CUDA driver calls that carve a
GMI's share of a card's SMs (CUDA green contexts from splits that keep
together the SMs a thread-block cluster may span) and the SM count of the
current context.

Part of the GMI control plane; no kernel and no TPU kernel stand behind it
(on the TPU a GMI owns whole chips, ``repro/core/gmi.py``).
``core/gmi.py`` uses these calls to give a GMI its SMs on one H100.  Every
call raises on a CUDA error; nothing falls back to the whole card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_PP = ctypes.POINTER(ctypes.c_void_p)
MAX_GROUPS = 64


@functools.cache
def _lib():
    lib = _build.load("sm_partition")
    for name, args in (("sm_split", [_I, _I, _I, _IP, _IP]),
                       ("sm_granularity", [_I, _IP]),
                       ("green_create", [_I, _I, _I, _IP, _I, _PP, _PP,
                                         _IP]),
                       ("green_push", [_P]), ("green_pop", [_P]),
                       ("ctx_sms", [_IP]),
                       ("diag_per_sm_context", [_I, _I, _I, _IP, _IP, _PP,
                                                _PP, _IP])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = _I
    return lib


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def granularity(device: int) -> int:
    """The SMs of the smallest group a split of card ``device`` makes."""
    out = ctypes.c_int()
    _check(_lib().sm_granularity(device, ctypes.byref(out)),
           "cuDevSmResourceSplitByCount (granularity)")
    return out.value


def split(device: int, groups: int, width: int) -> Tuple[int, ...]:
    """Each group's SMs in the one split of card ``device`` into ``groups``
    groups of ``width`` SMs (kept by the library once made); fewer groups
    than asked where the card cannot make them."""
    if not 1 <= groups <= MAX_GROUPS:
        raise ValueError(f"split: {groups} groups, at most {MAX_GROUPS}")
    got = ctypes.c_int()
    widths = (ctypes.c_int * groups)()
    _check(_lib().sm_split(device, groups, width, ctypes.byref(got),
                           widths),
           f"cuDevSmResourceSplitByCount ({groups} x {width} SMs)")
    return tuple(widths[:got.value])


def create(device: int, groups: int, width: int,
           slots: Sequence[int]) -> Tuple[int, int, int]:
    """A green context over groups ``slots`` of that split: (CUcontext,
    its stream, its SMs), the handles as ints."""
    arr = (ctypes.c_int * len(slots))(*slots)
    ctx, stream, sms = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
    _check(_lib().green_create(device, groups, width, arr, len(slots),
                               ctypes.byref(ctx), ctypes.byref(stream),
                               ctypes.byref(sms)),
           f"cuGreenCtxCreate over groups {list(slots)} of {groups} x "
           f"{width} SMs")
    return ctx.value, stream.value, sms.value


def push(ctx: int):
    _check(_lib().green_push(ctx), "cuCtxPushCurrent")


def pop(ctx: int):
    _check(_lib().green_pop(ctx), "cuCtxPopCurrent")


def current_sms() -> int:
    """The SMs of the current context: the whole card's in the primary
    context, a GMI's share inside its green context."""
    out = ctypes.c_int()
    _check(_lib().ctx_sms(ctypes.byref(out)), "cuCtxGetDevResource")
    return out.value


def diag_per_sm_context(device: int, groups: int,
                        width: int) -> Tuple[int, int, int, int, int]:
    """Diagnostic only (``gmi_probe.py``); no GMI uses it.  A green context
    over the first group of a split of card ``device`` into ``groups``
    groups of ``width`` SMs that treats each SM on its own: (that split
    mode's granularity, the groups made, CUcontext, its stream, its SMs)."""
    gran, got, sms = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ctx, stream = ctypes.c_void_p(), ctypes.c_void_p()
    _check(_lib().diag_per_sm_context(
        device, groups, width, ctypes.byref(gran), ctypes.byref(got),
        ctypes.byref(ctx), ctypes.byref(stream), ctypes.byref(sms)),
        f"a per-SM split into {groups} x {width} SMs")
    return gran.value, got.value, ctx.value, stream.value, sms.value
