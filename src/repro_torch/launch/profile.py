"""Where the time goes on the card: one PPO iteration, or serving steps.

``--workload ppo`` (default) runs warm-up iterations of the main path
(``make_env(env, megakernel=True)`` + ``PPOConfig(use_fused_kernels=True)``),
then one iteration under ``torch.profiler`` with CUDA activity.  With
``--gmi-per-gpu K`` it runs the multi-GMI launcher's loop instead
(``launch.steps.train_gmis`` over a 1 x K TCG_EX grid, ``--num-env`` envs
in total, each GMI on its own CUDA stream, ``--dispatch``): it sets the
GMIs up once, runs the warm-up iterations on that state and profiles one
further iteration.
``--workload serve`` builds a paged ``ServeEngine`` over
``--arch`` at full width (random weights), submits ``--batch`` prompts of
``--prompt-len`` tokens, and profiles the first engine step (the batched
whole-prompt prefill through the flash or mLSTM kernel, then one decode
step) and, after two warm-up steps, one decode-only step.  Each report
prints the wall time, the device's busy and idle shares (idle = 1 - union
of kernel intervals / wall time), the kernels' concurrency (their summed
time over the busy time: above 1 where streams overlap) and how many GAE
launches overlapped another kernel, device time by group (the port
kernels, cuBLAS GEMMs, everything else), and the top kernels by device
time.  For
a stack with sLSTM blocks (``--arch xlstm-1.3b``) each ``slstm_apply``
call runs inside a ``record_function`` range (no sync is added), and the
kernels that host ops inside such a range launched count in their own
group, "sLSTM blocks": its per-step plain ops are otherwise
indistinguishable from the rest.

``--workload lm`` builds ``--arch`` at full width (f32 master params, the
config's compute type) with Adam, runs two warm-up steps of
``launch/steps.py::make_train_step`` (no remat) on ``--batch`` x ``--seq``
tokens and profiles the third.  Ranges mark the backward of the two kernel
Functions (the plain recompute and its autograd), the cross-entropy chunks
(forward and their recompute in the backward) and the optimizer, and the
kernels launched inside each count in their own group beside the
attention kernel's forward, the remaining GEMMs and the rest.

    PYTHONPATH=src python -m repro_torch.launch.profile --env ShadowHand \
        --num-env 16384 --rollout 16
    PYTHONPATH=src python -m repro_torch.launch.profile --gmi-per-gpu 4
    PYTHONPATH=src python -m repro_torch.launch.profile --workload serve \
        --batch 8 --prompt-len 512
    PYTHONPATH=src python -m repro_torch.launch.profile --workload lm \
        --batch 4 --seq 512
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch


def _group(name: str) -> str:
    for key in ("env_mega_step", "fused_policy_mlp", "gae_",
                "paged_decode", "flash_attention", "mlstm_"):
        if key in name:
            return key.rstrip("_") + " (port kernel)"
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "nvjet" in low:
        return "GEMM (cuBLAS)"
    return "other"


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _profile(fn):
    """Run ``fn`` once under the profiler; returns (wall us, profile)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return wall_us, prof


SLSTM_RANGE = "slstm_apply"
# profiler ranges and the group their kernels count in
RANGES = {SLSTM_RANGE: "sLSTM blocks (plain ops)",
          "kernel_backward": "kernel backward (plain recompute + autograd)",
          "xent_chunk": "xent chunks (forward + recompute)",
          "optimizer": "optimizer (Adam)"}


def _mark(owner, attr, name, static=False):
    """Run ``owner.attr`` inside the profiler range ``name``, so the
    kernels it launches can be told apart."""
    inner = getattr(owner, attr)

    def marked(*a, **kw):
        with torch.profiler.record_function(name):
            return inner(*a, **kw)
    setattr(owner, attr, staticmethod(marked) if static else marked)


def _mark_slstm():
    from repro_torch.models import ssm
    _mark(ssm, "slstm_apply", SLSTM_RANGE)


def _report(title, wall_us, prof):
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    # a range also leaves a device-side annotation, which is no kernel
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in RANGES]
    ranges = [(e.time_range.start, e.time_range.end, RANGES[e.name])
              for e in events if e.name in RANGES and e.device_type == cpu]
    slstm = [(a, b) for a, b, g in ranges if g == RANGES[SLSTM_RANGE]]
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    by_group, by_name = defaultdict(float), defaultdict(float)
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_group[_group(e.name)] += dur
        by_name[e.name] += dur
    # each host op lists the kernels it launched (linked by correlation
    # id); those of ops that start inside a range move to its group (the
    # innermost, where ranges nest)
    for e in events:
        if e.device_type != cpu or e.name in RANGES:
            continue
        inside = [(b - a, g) for a, b, g in ranges
                  if a <= e.time_range.start < b]
        if inside:
            group = min(inside)[1]
            for k in e.kernels:
                if k.name not in RANGES:
                    by_group[_group(k.name)] -= k.duration
                    by_group[group] += k.duration
    if slstm:
        print(f"{title}: {len(slstm)} sLSTM blocks, "
              f"{sum(b - a for a, b in slstm) / 1e3:.3f} ms of host time "
              f"inside")
    print(f"{title}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}, "
          f"{len(kernels)} device events")
    spans = sorted((e.time_range.start, e.time_range.end, "gae_" in e.name)
                   for e in kernels)
    gae = [(a, b) for a, b, g in spans if g]
    shared = sum(any(a < e and s < b and (s, e) != (a, b)
                     for s, e, _ in spans) for a, b in gae)
    conc = sum(b - a for a, b, _ in spans) / busy_us
    print(f"{title}: concurrency {conc:.3f} (kernel time / busy time); GAE "
          f"launches overlapping another kernel: {shared} of {len(gae)}")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:32s} {us / 1e3:10.3f} ms  {us / wall_us:7.2%} of wall")
    print("top kernels:")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3:10.3f} ms  {n[:100]}")


def _serve(args):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_batch
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(args.arch)
    if "slstm" in (cfg.block_pattern or ()):
        _mark_slstm()
    eng = ServeEngine(cfg, T.init_model(args.seed, cfg, "cuda"),
                      max_slots=args.batch,
                      max_seq=args.prompt_len + args.gen + 8,
                      device="cuda")
    # warm-up: cuBLAS handles, bf16 GEMM heuristics, kernel builds
    eng.serve([Request(tokens=list(range(1, 40)), max_new_tokens=3)])
    toks = make_batch(cfg, InputShape("serve", args.prompt_len, args.batch,
                                      "prefill"), seed=args.seed)["tokens"]
    for i in range(args.batch):
        eng.submit(Request(tokens=toks[i], max_new_tokens=args.gen))
    title = f"{args.arch} full width, {args.batch} x {args.prompt_len}"
    _report(f"{title}: admission step (prefill + 1 decode step)",
            *_profile(eng.step))
    for _ in range(2):
        eng.step()
    _report(f"{title}: one decode step at {eng.active_count} rows",
            *_profile(eng.step))


def _lm(args):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, TrainConfig
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch import optim
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    cfg = get_config(args.arch)
    _mark(ops._FlashAttention, "backward", "kernel_backward", static=True)
    _mark(ops._MLSTMChunkwise, "backward", "kernel_backward", static=True)
    _mark(T, "_xent_chunk", "xent_chunk")
    _mark(optim, "adam_update", "optimizer")
    if "slstm" in (cfg.block_pattern or ()):
        _mark_slstm()
    params = T.init_model(args.seed, cfg, "cuda")
    opt = optim.adam_init(params)
    step, _ = steps.make_train_step(cfg, train_cfg=TrainConfig(remat=False))
    shape = InputShape("lm", args.seq, args.batch, "train")
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in
                make_batch(cfg, shape, seed=args.seed + i).items()}
               for i in range(3)]
    state = [params, opt]
    del params, opt
    for b in batches[:2]:
        state[:] = step(*state, b)[:2]

    def one():
        state[:] = step(*state, batches[2])[:2]
    _report(f"{args.arch} full width, {cfg.dtype} compute, f32 masters, "
            f"Adam, {args.batch} x {args.seq}: training step",
            *_profile(one))


def _gmis(args):
    from repro_torch.core.placement import plan_tcg_ex_training
    from repro_torch.envs import make_env
    from repro_torch.launch.steps import (init_gmis, make_drl_train_step,
                                          train_gmis)
    from repro_torch.rl.ppo import PPOConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    k = args.gmi_per_gpu
    env = make_env(args.env, megakernel=True, device="cuda")
    step, cfg = make_drl_train_step(env, PPOConfig(
        num_steps=args.rollout, lr=3e-4, use_fused_kernels=True))
    grid = plan_tcg_ex_training(1, k, devices=list(range(k)),
                                devices_per_gpu=k,
                                device="cuda").manager.instance_mesh(
                                    "holistic")

    states = init_gmis(grid, env, args.num_env, args.seed,
                       on_streams=args.dispatch == "streams")

    def run(iters):
        train_gmis(grid, env, step, cfg.num_steps, args.num_env, iters,
                   dispatch=args.dispatch, states=states)
    run(args.warmup)
    _report(f"{args.env} {k} GMIs x {args.num_env // k} envs T="
            f"{args.rollout} dispatch={args.dispatch}: iteration",
            *_profile(lambda: run(1)))


def main(argv=None):
    from repro_torch.envs import make_env
    from repro_torch.launch.steps import DISPATCH_MODES
    from repro_torch.rl.ppo import PPOConfig, init_train, make_train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("ppo", "serve", "lm"),
                    default="ppo")
    ap.add_argument("--env", default="ShadowHand")
    ap.add_argument("--num-env", type=int, default=16384)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--gmi-per-gpu", type=int, default=None)
    ap.add_argument("--dispatch", choices=DISPATCH_MODES, default="streams")
    args = ap.parse_args(argv)
    if args.workload == "serve":
        return _serve(args)
    if args.workload == "lm":
        return _lm(args)
    if args.gmi_per_gpu is not None:
        return _gmis(args)

    torch.backends.cuda.matmul.allow_tf32 = False
    env = make_env(args.env, megakernel=True, device="cuda")
    cfg = PPOConfig(num_steps=args.rollout, use_fused_kernels=True)
    state = list(init_train(args.seed, env, env.spec.policy_dims,
                            args.num_env, device="cuda"))
    step = make_train_step(env, cfg)
    for _ in range(args.warmup):
        state[:] = step(*state)[:5]

    def one():
        state[:] = step(*state)[:5]
    _report(f"{args.env} N={args.num_env} T={args.rollout}: iteration",
            *_profile(one))


if __name__ == "__main__":
    main()
