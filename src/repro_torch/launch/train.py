"""Training launcher (``--workload drl``): multi-instance synchronous PPO on
the paper's Table-6 envs, port of ``repro/launch/train.py``.

Instances are data-parallel copies that each train on ``num_env / n_inst``
envs; after every iteration their params are averaged (equivalent to
averaged gradients for identical optimizer states).  The env steps on the
env megakernel and PPO runs the fused GAE and acting-trunk kernels; on
``--device cpu`` those run their plain PyTorch versions.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --workload drl \
      --env ShadowHand --num-gpus 1 --gmi-per-gpu 1 --num-env 16384 \
      --device cuda
"""
from __future__ import annotations

import argparse
import time


def run_drl(args):
    from repro_torch.envs import make_env
    from repro_torch.rl.ppo import PPOConfig, init_train, make_train_step
    from repro_torch.utils import tree_map

    env = make_env(args.env, megakernel=True, device=args.device)
    cfg = PPOConfig(num_steps=args.rollout, lr=3e-4, use_fused_kernels=True)
    n_inst = args.num_gpus * args.gmi_per_gpu
    states = []
    for i in range(n_inst):
        p, o, es, ob, gen = init_train(args.seed + i, env,
                                       env.spec.policy_dims,
                                       num_envs=args.num_env // n_inst,
                                       device=args.device)
        states.append([p, o, es, ob, gen])
    step = make_train_step(env, cfg)

    t0 = time.time()
    total_steps = 0
    for it in range(args.iters):
        metrics = []
        for s in states:
            out = step(*s)
            s[:] = out[:5]
            metrics.append(out[5])
        if n_inst > 1:
            mean_p = tree_map(lambda *xs: sum(xs) / n_inst,
                              *[s[0] for s in states])
            for s in states:
                s[0] = mean_p
        total_steps += cfg.num_steps * args.num_env
        if it % max(args.iters // 10, 1) == 0:
            rm = sum(float(m["reward_mean"]) for m in metrics) / n_inst
            print(f"iter {it:4d} reward_mean={rm:8.3f} "
                  f"steps/s={total_steps / (time.time() - t0):,.0f}")
    print(f"done: {total_steps:,} env steps in {time.time()-t0:.1f}s "
          f"({total_steps/(time.time()-t0):,.0f} steps/s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=["drl"], default="drl")
    ap.add_argument("--env", default="Ant")
    ap.add_argument("--num-gpus", type=int, default=2)
    ap.add_argument("--gmi-per-gpu", type=int, default=2)
    ap.add_argument("--num-env", type=int, default=256)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    run_drl(ap.parse_args(argv))


if __name__ == "__main__":
    main()
