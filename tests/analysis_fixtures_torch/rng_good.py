"""Good fixture: every draw names its generator."""
import torch


def init(shape, w, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(shape, generator=gen)
    b = torch.randint(0, 10, shape, generator=gen)
    w.normal_(generator=gen)
    gen.manual_seed(seed + 1)
    return a, b, torch.zeros_like(a)
