"""End-to-end GMI-DRL run (the paper's headline workload), port of
``examples/multi_gmi_training.py``: synchronized PPO training across
multiple holistic GMIs with

  1. workload-aware selection (Algorithm 2) of (num_env, GMIperGPU), each
     point timed by the port's PPO profiler on ``--device``,
  2. the task-aware TCG_EX layout (holistic serving+training instances),
  3. Algorithm-1 choice of the gradient-reduction schedule, owned by the
     layout's Communicator,
  4. training iterations with global policy sync, each GMI on its own
     CUDA stream.

    PYTHONPATH=src python -m repro_torch.launch.multi_gmi_training \
        --iters 200
"""
from __future__ import annotations

import argparse


def main(argv=None):
    from repro_torch.core.placement import plan_tcg_ex_training
    from repro_torch.core.selection import explore, make_ppo_profiler
    from repro_torch.envs import make_env
    from repro_torch.launch.steps import (DISPATCH_MODES,
                                          make_drl_train_step, train_gmis)
    from repro_torch.rl.ppo import PPOConfig
    from repro_torch.utils import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="Ant")
    ap.add_argument("--num-gpus", type=int, default=2)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dispatch", choices=DISPATCH_MODES, default="streams")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1) Algorithm 2: profile-driven configuration search (reduced sweep)
    print("== Algorithm 2: workload-aware GMI selection ==")
    profile = make_ppo_profiler(iters=1, device=device)
    trace = explore(profile, args.env, num_gpu=args.num_gpus,
                    gmi_per_gpu_range=(2, 1), num_env_sweep=(128, 256, 512))
    num_env, gmi_per_gpu = trace.best_config
    print(f"selected num_env={num_env} GMIperGPU={gmi_per_gpu} "
          f"(projected {trace.best_throughput:,.0f} steps/s, "
          f"{len(trace.points)} profile points)")

    # 2) TCG_EX layout + 3) Algorithm 1 strategy, owned by the layout's
    #    Communicator: grid + strategy + grad-sync in one object
    layout = plan_tcg_ex_training(
        args.num_gpus, gmi_per_gpu,
        devices=list(range(args.num_gpus * gmi_per_gpu)),
        devices_per_gpu=gmi_per_gpu, device=device)
    comm = layout.communicator()
    strat = comm.strategy
    print(layout.manager.summary())
    print(f"Algorithm 1 gradient-reduction strategy: {strat.upper()} "
          f"(grid {comm.grid})")

    # 4) train: GMI i from seed i, as the reference's example
    env = make_env(args.env, megakernel=True, device=device)
    cfg = PPOConfig(num_steps=16, num_epochs=2, num_minibatches=2, lr=1e-3,
                    use_fused_kernels=True)
    step, cfg = make_drl_train_step(env, cfg)
    grid = layout.manager.instance_mesh("holistic")
    out = train_gmis(grid, env, step, cfg.num_steps, num_env, args.iters,
                     0, dispatch=args.dispatch,
                     log_every=max(args.iters // 10, 1))
    total = args.iters * cfg.num_steps * num_env
    print(f"\ntrained {total:,} env-steps on {len(grid.contexts)} GMIs "
          f"({strat.upper()} sync) in {sum(out['iter_s']):.1f}s "
          f"({out['steps_per_s']:,.0f} steps/s)")
    return dict(out, trace=trace, strategy=strat)


if __name__ == "__main__":
    main()
