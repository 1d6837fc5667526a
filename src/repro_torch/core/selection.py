"""Workload-aware GMI selection — profiling-based exploration (Algorithm 2),
port of ``repro/core/selection.py``.

Searches (GMIperGPU, num_env) to maximize projected system throughput,
pruning with the saturation metric Sat = ΔTOP/ΔMem < alpha.  The profile
function is pluggable: the real one times the port's PPO iteration on the
card; benchmarks may inject analytic or recorded profiles.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


@dataclass
class ProfilePoint:
    runnable: bool
    throughput: float     # env-steps / second
    memory: float         # bytes (or model-relative units)


@dataclass
class SearchTrace:
    points: List[Tuple[int, int, ProfilePoint, float]]  # (gpg, ne, prof, sat)
    best_config: Tuple[int, int]
    best_throughput: float


NUM_ENV_SWEEP = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def estimate_system_throughput(gmi_per_gpu: int, num_gpu: int,
                               top: float) -> float:
    """Line 20: project one instance's throughput to the whole system.

    Scaling is sub-linear in instances per GPU (shared HBM bandwidth):
    the paper's estimate() uses measured per-GMI throughput x instance
    count with a contention discount.
    """
    contention = 1.0 - 0.05 * (gmi_per_gpu - 1)
    return top * gmi_per_gpu * max(contention, 0.5) * num_gpu


def explore(profile: Callable[[str, int, int], ProfilePoint],
            drl_bench: str, num_gpu: int, *, alpha: float = 0.1,
            gmi_per_gpu_range=range(10, 0, -1),
            num_env_sweep=NUM_ENV_SWEEP) -> SearchTrace:
    """Algorithm 2, faithful to the pseudocode (incl. early-stop rules)."""
    best_config: Optional[Tuple[int, int]] = None
    max_top = float("-inf")
    trace: List[Tuple[int, int, ProfilePoint, float]] = []

    for gmi_per_gpu in gmi_per_gpu_range:
        pre_top = 0.0
        pre_mem = 0.0
        for num_env in num_env_sweep:
            prof = profile(drl_bench, gmi_per_gpu, num_env)
            if not prof.runnable:                      # line 6-8
                continue
            if pre_top == 0.0 and pre_mem == 0.0:      # line 9-12
                pre_top, pre_mem = prof.throughput, prof.memory
                trace.append((gmi_per_gpu, num_env, prof, float("inf")))
                # robustness beyond the paper's pseudocode: the first
                # runnable point is also a candidate (otherwise a space
                # with a single runnable config returns nothing)
                acc_top = estimate_system_throughput(gmi_per_gpu, num_gpu,
                                                     prof.throughput)
                if acc_top > max_top:
                    max_top = acc_top
                    best_config = (num_env, gmi_per_gpu)
                continue
            r_top = (prof.throughput - pre_top) / pre_top     # line 13
            r_mem = (prof.memory - pre_mem) / max(pre_mem, 1e-9)
            if r_mem <= 0.0:
                # The paper's Sat = ΔTOP/ΔMem assumes memory grows with
                # num_env.  When it is flat or shrinks (allocator slack,
                # recorded online profiles), the ratio is meaningless —
                # clamping the denominator exploded it to ±1e9·r_top,
                # either never pruning or aborting the sweep spuriously.
                # A throughput gain at no memory cost must never prune;
                # no gain at no cost means the sweep is saturated.
                sat = float("inf") if r_top > 0.0 else float("-inf")
            else:
                sat = r_top / r_mem                           # line 15
            pre_top, pre_mem = prof.throughput, prof.memory
            trace.append((gmi_per_gpu, num_env, prof, sat))
            if sat < alpha:                             # line 17-19
                break
            acc_top = estimate_system_throughput(gmi_per_gpu, num_gpu,
                                                 prof.throughput)
            if acc_top > max_top:                       # line 21-24
                max_top = acc_top
                best_config = (num_env, gmi_per_gpu)

    if best_config is None:
        raise RuntimeError("no runnable configuration found")
    return SearchTrace(trace, best_config, max_top)


# ------------------------------------------------------- real profiler -----
_RESOURCE_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED",
                     "OUT_OF_MEMORY", "out of memory", "Out of memory",
                     "OOM ", "failed to allocate")


def is_resource_exhausted(err: BaseException) -> bool:
    """Only allocator/OOM-type failures count as Alg. 2 'not runnable';
    anything else (shape bugs, NaN guards) is a genuine error."""
    if isinstance(err, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    return any(m in str(err) for m in _RESOURCE_MARKERS)


def make_ppo_profiler(iters: int = 3, mem_budget_bytes: float = 32e9,
                      device="cuda"):
    """Times the port's PPO iteration on ``device``: the megakernel env and
    the fused kernels on the card, their plain versions on the CPU.  One
    warm-up iteration, then ``iters`` timed ones inside a synchronised
    window.  GMIperGPU scales the per-instance resource slice by shrinking
    num_env headroom (1/GMIperGPU of the device), mirroring MPS percentage
    caps."""
    from repro_torch.envs import make_env
    from repro_torch.rl import ppo
    from repro_torch.utils import resolve_device
    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def profile(bench: str, gmi_per_gpu: int, num_env: int) -> ProfilePoint:
        env = make_env(bench, megakernel=True, device=device)
        eff_env = num_env // gmi_per_gpu
        if eff_env < 8:
            return ProfilePoint(False, 0.0, 0.0)
        spec = env.spec
        # memory model: obs/action/reward rollouts + policy + physics state
        bytes_per_env = 4 * (spec.obs_dim * 2 + spec.act_dim * 2 + 8) * 32
        mem = bytes_per_env * eff_env + 4e6
        if mem > mem_budget_bytes / gmi_per_gpu:
            return ProfilePoint(False, 0.0, mem)
        try:
            cfg = ppo.PPOConfig(num_steps=8, num_epochs=1, num_minibatches=1,
                                use_fused_kernels=True)
            state = list(ppo.init_train(0, env, spec.policy_dims,
                                        num_envs=eff_env, device=device))
            step = ppo.make_train_step(env, cfg)
            *state, m = step(*state)
            sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                *state, m = step(*state)
            sync()
            dt = (time.perf_counter() - t0) / iters
            top = cfg.num_steps * eff_env / dt
            return ProfilePoint(True, top, mem)
        except Exception as e:
            # resource exhaustion is the ONE failure Algorithm 2 expects
            # (config too big for the GMI slice -> not runnable); anything
            # else is a genuine bug and surfaces
            if is_resource_exhausted(e):
                return ProfilePoint(False, 0.0, mem)
            logger.exception(
                "profiler failed on (%s, gmi_per_gpu=%d, num_env=%d) with a "
                "non-resource error — surfacing it", bench, gmi_per_gpu,
                num_env)
            raise

    return profile
