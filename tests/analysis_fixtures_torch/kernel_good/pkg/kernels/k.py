"""Binding of csrc/k.cu."""
import ctypes


def _lib():
    lib = ctypes.CDLL("libk.so")
    lib.k_launch.restype = ctypes.c_int
    return lib


def _scratch():
    return _lib().k_scratch()


def launch(x):
    _scratch()
    return _lib().k_launch(x.data_ptr(), x.numel(), None)
