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


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def tree_size(tree) -> int:
    """Total number of tensor elements in a tree (meta and fake tensors
    included: only shapes are read)."""
    return sum(x.numel() for x in _tensors(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _tensors(tree))


def count_params(params) -> int:
    return tree_size(params)


def cast_tree(tree, dtype):
    """Floating-point leaves cast to ``dtype``; the others as they are."""
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)


def assert_finite(tree, name: str = "tree"):
    """Raise on the first leaf holding a NaN or an infinity.  Meta and fake
    tensors hold no values, so they pass."""
    from torch._subclasses.fake_tensor import FakeTensor
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        if not isinstance(leaf, torch.Tensor) or leaf.is_meta \
                or isinstance(leaf, FakeTensor):
            continue
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError(
                f"non-finite values in {name}{pytree.keystr(path)}")


def global_norm(tree) -> torch.Tensor:
    """The 2-norm of every leaf of ``tree`` together.  On DTensors each
    rank sums the squares of its shards, each divided by the number of
    ranks holding that same shard, and the sum over every rank is reduced
    once: the norm of the whole tree, replicated, never a shard's norm."""
    leaves = tree_leaves(tree)
    from torch.distributed.tensor import DTensor
    if leaves and isinstance(leaves[0], DTensor):
        return _global_norm_dist(leaves)
    leaves = [torch.sum(torch.square(x.float())) for x in leaves]
    return torch.sqrt(sum(leaves))


def _global_norm_dist(leaves) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dm = leaves[0].device_mesh
    total = 0.0
    for x in leaves:
        copies = 1
        for md, p in enumerate(x.placements):
            if not p.is_shard():
                copies *= dm.size(md)
        total = total + torch.sum(torch.square(x.to_local().float())) / copies
    part = DTensor.from_local(total, dm, [Partial()] * dm.ndim,
                              run_check=False)
    return torch.sqrt(part.redistribute(dm, [Replicate()] * dm.ndim))


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


def bf16_ulps(got, want, median=False) -> float:
    """The largest (``median``: the median) |got - want| over one bf16 ulp
    of ``want``'s own element (2^(e-7) for |want| in [2^e, 2^(e+1))) plus
    ``BF16_ATOL``: a largest of at most 1 passes the bf16 check."""
    w = want.float()
    _, e = torch.frexp(w)                 # |w| = m 2^e, m in [0.5, 1)
    ulp = torch.where(w != 0, torch.exp2((e - 8).float()),
                      torch.zeros_like(w))
    r = (got.float() - w).abs() / (ulp + BF16_ATOL)
    return float(r.median() if median else r.max())
