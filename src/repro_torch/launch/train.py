"""Training launcher (``--workload drl``): multi-GMI synchronous PPO on the
paper's Table-6 envs, port of ``repro/launch/train.py``.

It plans a TCG_EX layout of holistic GMIs, builds the layout's
Communicator (Algorithm 1 picks the LGR strategy), prints both, and runs
one PPO trainer per GMI, each GMI under its own CUDA stream on the card
(``--dispatch sequential``: all on the default stream, in turn), averaging
the params after every iteration.  The env steps on the env megakernel
and PPO runs the fused GAE and acting-trunk kernels; on ``--device cpu``
those run their plain PyTorch versions, one GMI after another.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --workload drl \
      --env ShadowHand --num-gpus 1 --gmi-per-gpu 4 --num-env 16384 \
      --device cuda
"""
from __future__ import annotations

import argparse

import torch


def run_drl(args):
    """Run the ``--workload drl`` path; returns :func:`train_gmis`'s dict
    plus the layout's ``summary`` and ``strategy``."""
    from repro_torch.core.placement import plan_tcg_ex_training
    from repro_torch.envs import make_env
    from repro_torch.launch.steps import make_drl_train_step, train_gmis
    from repro_torch.rl.ppo import PPOConfig
    from repro_torch.utils import resolve_device

    device = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    n_inst = args.num_gpus * args.gmi_per_gpu
    layout = plan_tcg_ex_training(
        args.num_gpus, args.gmi_per_gpu,
        devices=list(range(max(n_dev, n_inst))),
        devices_per_gpu=args.gmi_per_gpu, device=device)
    # the Communicator owns grid + strategy + grad-sync for this layout
    # (Algorithm 1 selection); the per-GMI steps consume it, not a
    # strategy string
    comm = layout.communicator()
    summary = layout.manager.summary()
    print(summary)
    print(f"LGR strategy (Algorithm 1 via repro_torch.comm): "
          f"{comm.strategy}")

    env = make_env(args.env, megakernel=True, device=device)
    cfg = PPOConfig(num_steps=args.rollout, lr=3e-4, use_fused_kernels=True)
    # as in the reference, a single instance takes the communicator (its
    # sync closure is the identity without a mesh); several stay
    # consistent through the parameter average
    step, cfg = make_drl_train_step(
        env, cfg, communicator=comm if n_inst == 1 else None)
    grid = layout.manager.instance_mesh("holistic")
    print(f"{n_inst} GMIs on {grid.device}, dispatch={args.dispatch}")
    out = train_gmis(grid, env, step, cfg.num_steps, args.num_env,
                     args.iters, args.seed, dispatch=args.dispatch,
                     log_every=max(args.iters // 10, 1))
    total = args.iters * cfg.num_steps * args.num_env
    print(f"done: {total:,} env steps in {sum(out['iter_s']):.1f}s "
          f"({out['steps_per_s']:,.0f} steps/s)")
    return dict(out, summary=summary, strategy=comm.strategy)


def main(argv=None):
    from repro_torch.launch.steps import DISPATCH_MODES
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
    ap.add_argument("--dispatch", choices=DISPATCH_MODES, default="streams")
    return run_drl(ap.parse_args(argv))


if __name__ == "__main__":
    main()
