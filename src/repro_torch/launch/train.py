"""Training launcher, port of ``repro/launch/train.py``.  Two modes:

* ``--workload drl``: multi-GMI synchronous PPO on the paper's Table-6
  envs.
* ``--workload lm``: LM-architecture training (:func:`run_lm`): the
  reduced config by default, ``--full`` the published one, f32 master
  params and Adam state with the config's compute type (bf16 at full
  width); the attention and mLSTM forwards run the hand-written kernels on
  the card, their gradients the plain math's.  ``--ckpt`` saves
  ``{"params", "opt"}`` in the reference's checkpoint format.

``--workload drl`` plans a TCG_EX layout of holistic GMIs, builds the layout's
Communicator (Algorithm 1 picks the LGR strategy), prints both, and runs
one PPO trainer per GMI, each GMI under its own CUDA stream on the card
(``--dispatch sequential``: all on the default stream, in turn), averaging
the params after every iteration.  The env steps on the env megakernel
and PPO runs the fused GAE and acting-trunk kernels; on ``--device cpu``
those run their plain PyTorch versions, one GMI after another.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --workload drl \
      --env ShadowHand --num-gpus 1 --gmi-per-gpu 4 --num-env 16384 \
      --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --workload lm \
      --arch internlm2-1.8b --full --steps 5 --batch 4 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --workload lm \
      --arch mixtral-8x7b --steps 10 --batch 4 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
import time

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


def run_lm(args):
    """Run the ``--workload lm`` path: ``args.steps`` Adam steps of
    ``loss_fn`` (no remat) on ``make_batch`` batches drawn from
    ``args.seed + i``.  Returns a dict: ``params``, ``opt``, ``losses``
    (floats) and ``step_s`` (each step's synchronised wall seconds)."""
    from repro_torch.checkpoint import save
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.configs.base import InputShape, TrainConfig
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam_init
    from repro_torch.utils import resolve_device

    device = resolve_device(args.device)
    cfg = (get_config if args.full else get_reduced)(args.arch)
    shape = InputShape("cli", args.seq, args.batch, "train")
    params = T.init_model(args.seed, cfg, device)
    opt = adam_init(params)
    step, _ = make_train_step(cfg, train_cfg=TrainConfig(
        learning_rate=args.lr, remat=False))
    print(f"training {args.arch} ({'full' if args.full else 'reduced'}: "
          f"{cfg.num_layers} layers, d {cfg.d_model}, compute {cfg.dtype}) "
          f"on {device}, batch {args.batch} x seq {args.seq}")
    losses, step_s = [], []
    for i in range(args.steps):
        batch = {k: torch.as_tensor(v, device=device) for k, v in
                 make_batch(cfg, shape, seed=args.seed + i).items()}
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i:4d} loss={losses[-1]:.4f}")
    print(f"done in {sum(step_s):.1f}s; final loss {losses[-1]:.4f}")
    if args.ckpt:
        save(args.ckpt, {"params": params, "opt": opt}, step=args.steps)
        print("checkpoint saved to", args.ckpt)
    return {"params": params, "opt": opt, "losses": losses,
            "step_s": step_s}


def main(argv=None):
    from repro_torch.launch.steps import DISPATCH_MODES
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=["drl", "lm"], default="drl")
    ap.add_argument("--env", default="Ant")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--full", action="store_true",
                    help="published widths (get_config) instead of the "
                         "reduced config (--workload lm)")
    ap.add_argument("--num-gpus", type=int, default=2)
    ap.add_argument("--gmi-per-gpu", type=int, default=2)
    ap.add_argument("--num-env", type=int, default=256)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dispatch", choices=DISPATCH_MODES, default="streams")
    args = ap.parse_args(argv)
    return run_drl(args) if args.workload == "drl" else run_lm(args)


if __name__ == "__main__":
    main()
