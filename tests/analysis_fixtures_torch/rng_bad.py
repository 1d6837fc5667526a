"""Bad fixture: draws from the process-wide generator."""
import torch
from torch import randn


def init(shape, w):
    torch.manual_seed(0)                    # BAD: seeds the global one
    a = torch.randn(shape)                  # BAD: no generator=
    b = torch.randint(0, 10, shape)         # BAD: no generator=
    c = torch.randperm(10)                  # BAD: no generator=
    d = randn(shape)                        # BAD: bare import, no generator=
    w.normal_()                             # BAD: in-place, no generator=
    e = torch.rand_like(a)                  # BAD: takes no generator
    torch.cuda.manual_seed_all(1)           # BAD: seeds the global ones
    return a, b, c, d, e
