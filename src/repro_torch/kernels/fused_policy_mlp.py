"""Binding of the CUDA fused policy-trunk kernel
(``csrc/fused_policy_mlp.cu``).

Replaces ``repro/kernels/fused_policy_mlp.py::fused_policy_mlp``: the tanh
MLP trunk, every layer in one launch, on the tensor cores at f32 accuracy
(3xTF32), after a small launch that splits the weights into TF32 parts laid
out as the kernel's MMAs read them, in a scratch buffer this wrapper
allocates.  Call it through ``ops.policy_mlp``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_WIDTH = 512
MAX_LAYERS = 8

_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn():
    f = _build.load("fused_policy_mlp").fused_policy_mlp_launch
    f.argtypes = [_P, _P, _I, _P, _P, _P, _I, _P, _P]
    f.restype = _I
    return f


def _scratch_floats(dims) -> int:
    """Floats of split-weight scratch for a trunk of these widths: each
    layer's hi and lo parts, din padded to 8 and dout to 64."""
    return sum(-(-a // 8) * -(-b // 64) * 64 * 16
               for a, b in zip(dims, dims[1:]))


def _check(x, shape, name):
    _build.check_tensor("policy_mlp", name, x, shape)


def launch(x, weights, biases):
    weights, biases = list(weights), list(biases)
    L = len(weights)
    if not 1 <= L <= MAX_LAYERS or len(biases) != L:
        raise ValueError(f"policy_mlp: 1..{MAX_LAYERS} layers with one "
                         f"bias each required, got {L} weights and "
                         f"{len(biases)} biases")
    N = x.shape[0]
    dims = [x.shape[1]] + [w.shape[1] for w in weights]
    if max(dims) > MAX_WIDTH:
        raise ValueError(f"policy_mlp: widths {dims} exceed the kernel's "
                         f"activation buffer of {MAX_WIDTH}")
    _check(x, (N, dims[0]), "x")
    for i, (w, b) in enumerate(zip(weights, biases)):
        _check(w, (dims[i], dims[i + 1]), f"weights[{i}]")
        _check(b, (dims[i + 1],), f"biases[{i}]")
    out = torch.empty((N, dims[-1]), dtype=torch.float32, device=x.device)
    scratch = torch.empty((_scratch_floats(dims),), dtype=torch.float32,
                          device=x.device)
    wp = (ctypes.c_void_p * L)(*[w.data_ptr() for w in weights])
    bp = (ctypes.c_void_p * L)(*[b.data_ptr() for b in biases])
    dp = (ctypes.c_int * (L + 1))(*dims)
    err = _fn()(x.data_ptr(), out.data_ptr(), N, wp, bp, dp, L,
                scratch.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"policy_mlp kernel launch failed: CUDA error "
                           f"{err}")
    return out
