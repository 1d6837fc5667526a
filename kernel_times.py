#!/usr/bin/env python3
"""Device times of the paged-decode and chunkwise mLSTM kernels at
``chip_smoke.py``'s timing shapes, in all and by launched kernel, and
each wrapper call's time by CUDA events (``chip_smoke.time_ms``), with
whichever ``repro_torch`` is on ``PYTHONPATH``, printed as one JSON line.

    PYTHONPATH=src python3 kernel_times.py
    PYTHONPATH=OTHER_CHECKOUT/src python3 kernel_times.py

Running it with two checkouts' ``src/`` in turns on one card compares two
versions of the kernels through the same inputs and the same profiler
timing (``chip_smoke.device_times``).  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    fc = get_config(cs.ARCH)
    paged = cs.paged_inputs(8, fc.num_heads, fc.num_kv_heads,
                            fc.resolved_head_dim, 8, 128, cs.DECODE_POS, gen,
                            dev, torch.bfloat16)
    *shape, chunk, zero = cs.MLSTM_MAIN[0]
    ml = cs.mlstm_inputs(*shape, zero, gen, dev)
    calls = {"paged_attention": lambda: ops.paged_attention(*paged),
             "mlstm_chunkwise": lambda: ops.mlstm_chunkwise(*ml, chunk=chunk)}
    res = {"repro_torch": repro_torch.__file__, "card": cs.card_line()}
    for name, fn in calls.items():
        by_kernel = cs.device_times(fn)
        res[name] = sum(by_kernel.values()) or None
        res[name + "_by_kernel"] = by_kernel
        res[name + "_call_ms"] = cs.time_ms(fn)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
