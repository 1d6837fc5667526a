"""Small shared utilities: device resolution, pytree helpers, init."""
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
