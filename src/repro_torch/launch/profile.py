"""Where the time of one PPO iteration goes on the card.

Runs warm-up iterations of the main path (``make_env(env, megakernel=True)``
+ ``PPOConfig(use_fused_kernels=True)``), then one iteration under
``torch.profiler`` with CUDA activity, and prints the iteration's wall time,
the device's busy and idle shares (idle = 1 - union of kernel intervals /
wall time), device time by group (the three port kernels, cuBLAS GEMMs of
the PPO update, everything else), and the top kernels by device time.

    PYTHONPATH=src python -m repro_torch.launch.profile --env ShadowHand \
        --num-env 16384 --rollout 16
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch


def _group(name: str) -> str:
    for key in ("env_mega_step", "fused_policy_mlp", "gae_"):
        if key in name:
            return key.rstrip("_") + " (port kernel)"
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "GEMM (cuBLAS)"
    return "other"


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def main(argv=None):
    from repro_torch.envs import make_env
    from repro_torch.rl.ppo import PPOConfig, init_train, make_train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="ShadowHand")
    ap.add_argument("--num-env", type=int, default=16384)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    env = make_env(args.env, megakernel=True, device="cuda")
    cfg = PPOConfig(num_steps=args.rollout, use_fused_kernels=True)
    state = list(init_train(args.seed, env, env.spec.policy_dims,
                            args.num_env, device="cuda"))
    step = make_train_step(env, cfg)
    for _ in range(args.warmup):
        state[:] = step(*state)[:5]
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state[:] = step(*state)[:5]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    by_group, by_name = defaultdict(float), defaultdict(float)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_group[_group(e.name)] += dur
        by_name[e.name] += dur
    print(f"{args.env} N={args.num_env} T={args.rollout}: iteration wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / wall_us:.4f}, {len(kernels)} device "
          "events")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:32s} {us / 1e3:10.3f} ms  {us / wall_us:7.2%} of wall")
    print("top kernels:")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3:10.3f} ms  {n[:100]}")


if __name__ == "__main__":
    main()
