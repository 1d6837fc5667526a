"""Bad fixture: host syncs inside a # repro: hot function (the torch
forms)."""
import time

import numpy as np
import torch


# repro: hot
def decode_step(x, ev):
    t0 = time.perf_counter()        # BAD: host timing in hot path
    host = np.asarray(x)            # BAD: device->host copy
    v = x.item()                    # BAD: scalar readback
    ids = x.tolist()                # BAD: list readback
    c = x.cpu()                     # BAD: device->host copy
    n = c.numpy()                   # BAD: host array
    torch.cuda.synchronize()        # BAD: waits for the device
    ev.synchronize()                # BAD: waits for an event
    f = float(x)                    # BAD: scalar readback
    return host, v, ids, n, f, time.perf_counter() - t0   # BAD: timing
