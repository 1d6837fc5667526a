"""Small shared utilities: device resolution, pytree helpers, init, the
bf16 accuracy gate."""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

tree_map = pytree.tree_map
tree_leaves = pytree.tree_leaves
tree_flatten = pytree.tree_flatten
tree_unflatten = pytree.tree_unflatten


def resolve_device(device) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU: a CUDA
    device without a card raises here instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def he_init(gen: torch.Generator, shape):
    """He-normal weights on ``gen.device``, fan-in = ``shape[0]``."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * (2.0 / shape[0]) ** 0.5


def lecun_init(gen: torch.Generator, shape, fan_in=None):
    """LeCun-normal weights on ``gen.device``, fan-in ``fan_in`` or
    ``shape[0]``."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * (1.0 / (fan_in or shape[0])) \
        ** 0.5


# bf16 outputs are held to one bf16 ulp of each element's own magnitude,
# plus BF16_ATOL for elements near 0 whose ulp is below the f32 sums'
# rounding
BF16_ATOL = 2.0 ** -14


def bf16_ulps(got, want) -> float:
    """The largest |got - want| over one bf16 ulp of ``want``'s own element
    (2^(e-7) for |want| in [2^e, 2^(e+1))) plus ``BF16_ATOL``: at most 1
    passes the bf16 check."""
    w = want.float()
    _, e = torch.frexp(w)                 # |w| = m 2^e, m in [0.5, 1)
    ulp = torch.where(w != 0, torch.exp2((e - 8).float()),
                      torch.zeros_like(w))
    return float(((got.float() - w).abs() / (ulp + BF16_ATOL)).max())
