"""Asynchronous A3C over the MCC experience ring (paper §4.2, Fig. 6b),
the runnable counterpart of ``examples/async_a3c_channels.py``.

Serving GMIs collect experience with a stale policy snapshot, the
Dispenser -> Compressor -> Migrator -> Batcher pipeline ships it through
the ring, and trainer GMIs update the policy; n-step returns run on the
n-step kernel.  ``--megakernel`` puts the env on the env megakernel, and
on a blocking ring the actors then write experience straight into the
ring slot (``collect_ring``); without it each push is packed by the
ring-pack kernel.  ``--overlap`` double-buffers the ring, so each round
trains on the previous round's experience.  ``--device cpu`` runs the
plain PyTorch versions.

Two ways to lay the GMIs out:

* ``--serving-gmis S --trainer-gmis K`` (the default): serving GMIs
  ``0 .. S-1`` and trainer GMIs ``S .. S+K-1`` on one ring, no placement;
* ``--num-gpus G --serving-gpus s --gmi-per-gpu k``: an async placement
  (``plan_async``; logical GPUs on one card) through ``make_async_runner``,
  one ring per serving GPU; the three are given together.
  ``--online-controller`` needs that layout and attaches the online
  Algorithm-2 controller, re-planning the serving:training split and
  num_env between epochs over ``--num-env-sweep``; at the end its summary
  and every decision are printed, as the example does.

    PYTHONPATH=src python -m repro_torch.launch.async_a3c --env ShadowHand \
        --num-env 8192 --rollout 16 --rounds 10 --megakernel --device cuda
    PYTHONPATH=src python -m repro_torch.launch.async_a3c --env Anymal \
        --num-gpus 2 --serving-gpus 1 --gmi-per-gpu 2 --overlap \
        --online-controller --num-env-sweep 64,128,256 --device cuda
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    from repro_torch.envs import make_env

    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="Anymal")
    ap.add_argument("--num-env", type=int, default=64)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serving-gmis", type=int, default=2)
    ap.add_argument("--trainer-gmis", type=int, default=1)
    ap.add_argument("--num-gpus", type=int, default=None)
    ap.add_argument("--serving-gpus", type=int, default=None)
    ap.add_argument("--gmi-per-gpu", type=int, default=None)
    ap.add_argument("--online-controller", action="store_true")
    ap.add_argument("--num-env-sweep", default=None,
                    help="comma-separated num_env ladder of the controller")
    ap.add_argument("--megakernel", action="store_true")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    placement = (args.num_gpus, args.serving_gpus, args.gmi_per_gpu)
    placed = any(v is not None for v in placement)
    if placed and None in placement:
        ap.error("--num-gpus, --serving-gpus and --gmi-per-gpu are given "
                 "together")
    if args.online_controller and not placed:
        ap.error("--online-controller needs the layout flags --num-gpus, "
                 "--serving-gpus and --gmi-per-gpu")

    env = make_env(args.env, megakernel=args.megakernel, device=args.device)
    kw = dict(num_envs=args.num_env, num_steps=args.rollout, seed=args.seed,
              overlap=args.overlap, use_fused_kernels=True,
              device=args.device)
    if placed:
        from repro_torch.core.controller import ControllerConfig
        from repro_torch.core.placement import plan_async
        from repro_torch.launch.steps import make_async_runner
        G, s, k = placement
        layout = plan_async(G, s, k,
                            devices=list(range(G * k)), devices_per_gpu=k,
                            device=args.device)
        print(layout.manager.summary())
        cfg = None
        if args.num_env_sweep:
            cfg = ControllerConfig(num_env_sweep=tuple(
                int(x) for x in args.num_env_sweep.split(",")))
        runner = make_async_runner(
            env, layout, online_controller=args.online_controller,
            controller_cfg=cfg, **kw)
    else:
        from repro_torch.rl.a3c import AsyncRunner
        serving = list(range(args.serving_gmis))
        trainers = list(range(args.serving_gmis,
                              args.serving_gmis + args.trainer_gmis))
        runner = AsyncRunner(env, serving, trainers, **kw)

    def sync():
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)

    t0 = time.perf_counter()
    for rnd in range(args.rounds):
        losses, stale = runner.round()
        sync()
        dt = time.perf_counter() - t0
        loss = f"{np.mean(losses):8.4f}" if losses else "     n/a"
        print(f"round {rnd:3d} loss={loss} staleness={stale} "
              f"steps/s={runner.predictions / dt:,.0f} "
              f"trained/s={runner.trained_samples / dt:,.0f}")
    losses, stale = runner.finish()     # train on the in-flight tail
    sync()
    if losses:
        print(f"finish: loss={np.mean(losses):.4f} staleness={stale}")
    s = runner.pipe.stats
    print(f"channel pipeline: {s.num_transfers} transfers, "
          f"{s.bytes_per_transfer:,.0f} B/transfer "
          f"({s.total_bytes / 2**20:.1f} MiB total), "
          f"{runner.pipe.spill_count} spills; delivered == predicted: "
          f"{runner.trained_samples == runner.predictions}")
    if runner.controller is not None:
        print(runner.controller.summary())
        for d in runner.controller.decisions:
            print(f"  re-plan: {d.reason} -> serving_gpus={d.serving_gpus},"
                  f" gmi_per_gpu={d.gmi_per_gpu}, num_env={d.num_env}")
    return runner


if __name__ == "__main__":
    main()
