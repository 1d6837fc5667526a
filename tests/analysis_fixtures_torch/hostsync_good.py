"""Good fixture: the same constructs outside hot code, constant float(),
and a deliberate sync that carries its allow comment."""
import time

import torch


def report(x):
    # not marked hot: free to read back
    return x.item(), x.tolist(), time.perf_counter()


# repro: hot
def decode_step(x, scale):
    y = x * float(2)
    # the one readback a step: continuous batching needs the ids
    # repro: allow(host-sync-in-hot-path)
    ids = y.cpu().numpy()
    return torch.as_tensor(ids)
