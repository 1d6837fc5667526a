"""Asynchronous A3C over the MCC experience ring (paper §4.2, Fig. 6b),
counterpart of ``examples/async_a3c_channels.py`` without the online
controller.

Serving GMIs ``0 .. S-1`` collect experience with a stale policy snapshot,
the Dispenser -> Compressor -> Migrator -> Batcher pipeline ships it
through one ring of S slots, and trainer GMIs ``S .. S+K-1`` update the
policy; n-step returns run on the n-step kernel.  ``--megakernel``
puts the env on the env megakernel, and on a blocking ring the actors
then write experience straight into the ring slot (``collect_ring``);
without it each push is packed by the ring-pack kernel.  ``--overlap``
double-buffers the ring, so each round trains on the previous round's
experience.  ``--device cpu`` runs the plain PyTorch versions.

    PYTHONPATH=src python -m repro_torch.launch.async_a3c --env ShadowHand \
        --num-env 8192 --rollout 16 --rounds 10 --megakernel --device cuda
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    from repro_torch.envs import make_env
    from repro_torch.rl.a3c import AsyncRunner

    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="Anymal")
    ap.add_argument("--num-env", type=int, default=64)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--serving-gmis", type=int, default=2)
    ap.add_argument("--trainer-gmis", type=int, default=1)
    ap.add_argument("--megakernel", action="store_true")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    env = make_env(args.env, megakernel=args.megakernel, device=args.device)
    serving = list(range(args.serving_gmis))
    trainers = list(range(args.serving_gmis,
                          args.serving_gmis + args.trainer_gmis))
    runner = AsyncRunner(env, serving, trainers, num_envs=args.num_env,
                         num_steps=args.rollout, seed=args.seed,
                         overlap=args.overlap, use_fused_kernels=True,
                         device=args.device)

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
    return runner


if __name__ == "__main__":
    main()
