#!/usr/bin/env python3
"""Device times of the env step, GAE, paged-decode and chunkwise mLSTM
kernels at ``chip_smoke.py``'s timing shapes, in all and by launched
kernel, each wrapper call's time by CUDA events (``chip_smoke.time_ms``),
its host time on its own (``chip_smoke.host_ms``) and its bound from
``kernels/cost.py`` (where the checkout has it), with whichever
``repro_torch`` is on ``PYTHONPATH``, printed as one JSON line.

    PYTHONPATH=src python3 kernel_times.py
    PYTHONPATH=OTHER_CHECKOUT/src python3 kernel_times.py

Running it with two checkouts' ``src/`` in turns on one card compares two
versions of the kernels through the same inputs and the same profiler
timing (``chip_smoke.device_times``).  The env step is also timed with
its sensor cut to one column (``env_physics_only``): the observation
projection then does 1/211 of its work, so that time is the physics, and
the difference to the full step the observation; and with 1, 2 and 8
substeps (``env_mega_step_substeps<k>``; the step takes 4), which parts
the substep loop from the step's fixed cost.  Where the env kernel
takes its lane-group width at build time (``-DENV_LANES``; the checkout's
``env_megakernel.bind`` marks it), the step is also timed built at the
other widths, 8 and 32 lanes an env, into ``build/kernel_times/``.
Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

import chip_smoke as cs

OTHER_LANES = (8, 32)


def env_lane_variants(_build, env_megakernel):
    """{lanes: launch function} of the env kernel built with each of
    OTHER_LANES lanes an env, all sources compiled at once."""
    out = _build.BUILD_ROOT.parent / "kernel_times"
    out.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "env_megakernel.cu"
    procs = {g: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-DENV_LANES={g}", "-I",
         str(_build.CSRC), "-o", str(out / f"libenv_lanes{g}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for g in OTHER_LANES}
    for g, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for ENV_LANES={g}:\n{log}")
    return {g: env_megakernel.bind(
        ctypes.CDLL(str(out / f"libenv_lanes{g}.so"))) for g in OTHER_LANES}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, env_megakernel, ops
    try:
        from repro_torch.kernels import cost
    except ImportError:          # a checkout from before kernels/cost.py
        cost = None
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    env, st, action, obs0, consts, kw = cs.env_inputs(cs.ENV, cs.N_MAIN,
                                                      gen, dev)
    sensor1 = consts[0][:, :1].contiguous()
    gae = cs.gae_inputs(cs.T_MAIN, cs.N_MAIN, gen, dev)
    fc = get_config(cs.ARCH)
    paged = cs.paged_inputs(8, fc.num_heads, fc.num_kv_heads,
                            fc.resolved_head_dim, 8, 128, cs.DECODE_POS, gen,
                            dev, torch.bfloat16)
    *shape, chunk, zero = cs.MLSTM_MAIN[0]
    ml = cs.mlstm_inputs(*shape, zero, gen, dev)
    calls = {
        "env_mega_step": lambda: ops.env_mega_step(
            *st, action, obs0, None, 0, 0, *consts, **kw),
        "env_physics_only": lambda: ops.env_mega_step(
            *st, action, obs0, None, 0, 0, sensor1, *consts[1:], **kw),
        "gae_norm": lambda: ops.gae_norm(*gae),
        "paged_attention": lambda: ops.paged_attention(*paged),
        "mlstm_chunkwise": lambda: ops.mlstm_chunkwise(*ml, chunk=chunk)}
    res = {"repro_torch": repro_torch.__file__, "card": cs.card_line()}
    if cost is not None:
        spec = env.spec
        B, H, S, dh = shape
        for name, (nbytes, nops, *peak) in {
                "env_mega_step": cost.env_mega_step(
                    cs.N_MAIN, spec.act_dim, spec.obs_dim, spec.substeps),
                "gae_norm": cost.gae_norm(cs.T_MAIN, cs.N_MAIN),
                "paged_attention": (*cost.paged_attention(*paged),
                                    cost.PEAK_BF16),
                "mlstm_chunkwise": (*cost.mlstm_chunkwise(B, H, S, dh,
                                                          chunk),
                                    cost.PEAK_3XTF32)}.items():
            res[name + "_bound_ms"] = cost.bound_ms(nbytes, nops, *peak)[0]
    for name, fn in calls.items():
        by_kernel = cs.device_times(fn)
        res[name] = sum(by_kernel.values()) or None
        res[name + "_by_kernel"] = by_kernel
        res[name + "_call_ms"] = cs.time_ms(fn)
        res[name + "_host_ms"] = cs.host_ms(fn)
    for k in (1, 2, 8):
        kw_k = dict(kw, substeps=k)
        res[f"env_mega_step_substeps{k}"] = sum(cs.device_times(
            lambda: ops.env_mega_step(*st, action, obs0, None, 0, 0, *consts,
                                      **kw_k)).values()) or None
    if hasattr(env_megakernel, "bind"):
        kept = env_megakernel._fn
        for g, f in env_lane_variants(_build, env_megakernel).items():
            env_megakernel._fn = lambda f=f: f
            res[f"env_mega_step_lanes{g}"] = sum(cs.device_times(
                calls["env_mega_step"]).values()) or None
        env_megakernel._fn = kept
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
