#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's two paths: synchronous PPO and
asynchronous A3C over the MCC experience ring.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (PATH or /usr/local/cuda/bin).  Phases,
each asserting, in order:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (all sources in
   parallel) and print the build time, nvcc's register/spill report and
   the card's name and power limit;
2. hold each of the five kernels against its plain PyTorch version on the
   card at its path's shapes (ShadowHand, N = 16384, a share of envs
   forced to reset; the env megakernel without and with ring writes; GAE
   and the n-step scan at T = 16, N = 16384; the trunk at 16384 x 211 ->
   256; the ring pack of one A3C push, T = 16, N = 8192, slot 1 of 2, the
   other slot a sentinel, bit-exact) and at a ragged N (every Table-6 env
   and trunk width, GAE and the n-step scan at T = 5, the pack at
   N = 999 with a version tensor);
3. check one small fused PPO iteration on the card against the plain
   PyTorch path on the CPU from the same params, state, noise and
   permutations;
4. check two small A3C rounds on the card against the CPU path, on both
   branches of ``AsyncRunner.round`` (direct produce into the ring, and
   collect + ring pack), from the same params, state and noise;
5. drive the PPO path: ``make_env("ShadowHand", megakernel=True)`` and
   ``PPOConfig(num_steps=16, use_fused_kernels=True)`` at N = 16384 for
   3 iterations, with the launch counters set to 0 just before and read
   just after;
6. drive the A3C path: ShadowHand, 2 serving GMIs of N = 8192 envs and 1
   trainer GMI on one 2-slot ring, T = 16, ``use_fused_kernels=True``, 3
   rounds on each branch (``megakernel=True`` produces into the ring,
   ``megakernel=False`` pushes through the ring pack), each with the
   launch counters set to 0 just before and read just after;
7. time each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events, and print one
   ``{"kernels": [...]}`` line.

Float32 matmuls run without TF32 (``allow_tf32 = False``) so the plain
versions are full fp32, as the kernels are.  The last line is the
``{"ok": true, "device": ...}`` contract line.  Without a CUDA card, or
without the repository's ``src/`` beside it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ENV = "ShadowHand"
N_MAIN = 16384
T_MAIN = 16
N_RAGGED = 1000
N_A3C = 8192             # envs per serving GMI
N_PACK_RAGGED = 999      # s*N*211 not a multiple of 4: unaligned runs
A3C_ROUNDS = 3
PEAK_BYTES = 3.35e12     # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12         # H100 SXM fp32 outside the tensor cores, flop/s
TOL = {"env_mega_step": 1e-4, "gae_norm": 1e-4, "policy_mlp": 1e-4,
       "nstep_returns": 1e-5, "pack_channels": 0.0}
KERNELS = {
    "env_mega_step": ("src/repro_torch/csrc/env_megakernel.cu",
                      "src/repro/kernels/env_megakernel.py:179"),
    "gae_norm": ("src/repro_torch/csrc/gae_scan.cu",
                 "src/repro/kernels/gae_scan.py:57"),
    "policy_mlp": ("src/repro_torch/csrc/fused_policy_mlp.cu",
                   "src/repro/kernels/fused_policy_mlp.py:37"),
    "nstep_returns": ("src/repro_torch/csrc/gae_scan.cu",
                      "src/repro/kernels/gae_scan.py:98"),
    "pack_channels": ("src/repro_torch/csrc/channel_pack.cu",
                      "src/repro/kernels/channel_pack.py:103"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def time_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------- inputs ----
def env_inputs(name, n, gen, dev):
    from repro_torch.envs import make_env
    from repro_torch.kernels import ref
    env = make_env(name, megakernel=True, device=dev)
    state, obs = env.reset(gen, n)
    mc = env.mega
    kw = dict(chain=mc.chain, task=mc.task, substeps=env.spec.substeps,
              dt=env.spec.dt, max_episode_len=env.spec.max_episode_len)
    J = env.spec.act_dim
    # a few plain steps so joint velocities and the root are not at rest
    for _ in range(3):
        a = torch.rand((n, J), generator=gen, device=dev) * 2 - 1
        out = ref.mega_step(*state, a, obs, None, 0, 0, mc.sensor, mc.tgt,
                            mc.masses, mc.lengths, **kw)
        state, obs = out[:7], out[7]
    state = list(state)
    t = state[4].clone()
    t[::8] = env.spec.max_episode_len - 1      # force 1/8 of envs to reset
    state[4] = t
    action = torch.rand((n, J), generator=gen, device=dev) * 3 - 1.5
    consts = (mc.sensor, mc.tgt, mc.masses, mc.lengths)
    return env, state, action, obs, consts, kw


def ring(T, S, n, sp, dev, fill=-7.0):
    return {"obs": torch.full((T, S * n, sp.obs_dim), fill, device=dev),
            "actions": torch.full((T, S * n, sp.act_dim), fill, device=dev),
            "rewards": torch.full((T, S * n), fill, device=dev),
            "dones": torch.full((T, S * n), fill, device=dev)}


def trunk_inputs(dims, n, gen, dev):
    x = torch.rand((n, dims[0]), generator=gen, device=dev) * 2 - 1
    ws = [torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev)
          * (2.0 / dims[i]) ** 0.5 for i in range(len(dims) - 2)]
    bs = [torch.randn((dims[i + 1],), generator=gen, device=dev) * 0.1
          for i in range(len(dims) - 2)]
    return x, ws, bs


def gae_inputs(T, n, gen, dev):
    r = torch.randn((T, n), generator=gen, device=dev)
    v = torch.randn((T, n), generator=gen, device=dev)
    d = (torch.rand((T, n), generator=gen, device=dev) < 0.05).float()
    last = torch.randn((n,), generator=gen, device=dev)
    return r, v, d, last


def pack_inputs(T, S, n, spec, gen, dev, version, fill=-7.0):
    """One push's payloads and ring buffers of S slots pre-filled with a
    sentinel."""
    pay = {"obs": torch.randn((T, n, spec.obs_dim), generator=gen, device=dev),
           "actions": torch.randn((T, n, spec.act_dim), generator=gen,
                                  device=dev),
           "rewards": torch.randn((T, n), generator=gen, device=dev),
           "dones": (torch.rand((T, n), generator=gen, device=dev)
                     < 0.05).float(),
           "bootstrap": torch.randn((n,), generator=gen, device=dev),
           "actor_version": version}
    bufs = ring(T, S, n, spec, dev, fill)
    bufs["bootstrap"] = torch.full((S, n), fill, device=dev)
    bufs["actor_version"] = torch.full((S, 1), -7, dtype=torch.int32,
                                       device=dev)
    return pay, bufs


# ------------------------------------------------------------- checks ----
def check_env(name, n, gen, dev, with_ring: bool) -> float:
    from repro_torch.kernels import ops, ref
    env, state, action, obs, consts, kw = env_inputs(name, n, gen, dev)
    T, S, slot, step_t = 4, 2, 1, 2
    bk = ring(T, S, n, env.spec, dev) if with_ring else None
    br = ring(T, S, n, env.spec, dev) if with_ring else None
    got = ops.env_mega_step(*state, action, obs, bk, step_t, slot, *consts,
                            **kw)
    want = ref.mega_step(*state, action, obs, br, step_t, slot, *consts,
                         **kw)
    want2 = ref.env_mega_step_ref(*state, action, obs, None, step_t, slot,
                                  *consts, **kw)
    torch.cuda.synchronize()
    err = 0.0
    names = ("q", "qd", "root", "prev_action", "t", "seed", "resets", "obs",
             "reward", "done")
    for nm, g, w, w2 in zip(names, got[:10], want[:10], want2[:10]):
        if g.dtype == torch.int32 or nm == "done":
            assert torch.equal(g, w) and torch.equal(g, w2), (name, nm)
        else:
            e = max(max_err(g, w), max_err(g, w2))
            assert e <= TOL["env_mega_step"], (name, nm, e)
            err = max(err, e)
    assert bool((got[9] > 0).any()), "no env was reset"
    if with_ring:
        for c in ("obs", "actions", "rewards", "dones"):
            e = max_err(bk[c], br[c])
            assert e <= TOL["env_mega_step"], (name, c, e)
            err = max(err, e)
            keep = torch.ones_like(bk[c], dtype=torch.bool)
            keep[step_t, slot * n:(slot + 1) * n] = False
            assert bool((bk[c][keep] == -7.0).all()), f"sentinel lost: {c}"
    return err


def check_gae(T, n, gen, dev) -> float:
    from repro_torch.kernels import ops, ref
    args = gae_inputs(T, n, gen, dev)
    ga, gr = ops.gae_norm(*args)
    wa, wr = ref.gae_norm_ref(*args)
    torch.cuda.synchronize()
    err = max(max_err(ga, wa), max_err(gr, wr))
    assert err <= TOL["gae_norm"], ("gae_norm", T, n, err)
    return err


def check_trunk(dims, n, gen, dev) -> float:
    from repro_torch.kernels import ops, ref
    x, ws, bs = trunk_inputs(dims, n, gen, dev)
    err = max_err(ops.policy_mlp(x, ws, bs), ref.policy_mlp_ref(x, ws, bs))
    assert err <= TOL["policy_mlp"], ("policy_mlp", dims, n, err)
    return err


def check_nstep(T, n, gen, dev) -> float:
    from repro_torch.kernels import ops, ref
    r, _, d, boot = gae_inputs(T, n, gen, dev)
    err = max_err(ops.nstep_returns(r, d, boot),
                  ref.nstep_returns_ref(r, d, boot))
    assert err <= TOL["nstep_returns"], ("nstep_returns", T, n, err)
    return err


def check_pack(T, n, spec, gen, dev, version) -> float:
    """Slot 1 of a 2-slot ring: the kernel's rings equal the plain
    version's bit for bit, slot 1 holds the payload and slot 0 keeps its
    sentinel."""
    from repro_torch.kernels import ops, ref
    S, slot = 2, 1
    pay, bk = pack_inputs(T, S, n, spec, gen, dev, version)
    br = {c: b.clone() for c, b in bk.items()}
    assert ops.pack_channels(bk, pay, slot) is bk
    ref.pack_channels_ref(br, pay, slot)
    torch.cuda.synchronize()
    for c in bk:
        assert torch.equal(bk[c], br[c]), ("pack_channels", n, c)
        rows = c in ("bootstrap", "actor_version")
        mine = bk[c][slot] if rows else bk[c][:, slot * n:(slot + 1) * n]
        other = bk[c][0] if rows else bk[c][:, :n]
        assert bool((other == -7).all()), f"sentinel lost: {c}"
        want = torch.as_tensor(pay[c], device=dev).reshape(mine.shape)
        assert torch.equal(mine, want.to(mine.dtype)), ("slot", c)
    return max(max_err(bk[c], br[c]) for c in bk)


def check_small_iteration(dev):
    """One fused PPO iteration on the card (kernels) against the plain
    PyTorch path on the CPU, from the same params, env state, noise and
    permutations.  Losses and rewards agree to 1e-4.  The iteration's 4
    Adam steps at lr = 3e-4 move a param by at most about 1.2e-3, so the
    check first asserts that the CPU run moved some param by more than
    1e-4 (an update really happened), then holds the card's params to the
    CPU's within 1e-5, a few percent of one step."""
    from repro_torch.envs import make_env
    from repro_torch.rl.ppo import PPOConfig, init_train, train_iteration
    from repro_torch.utils import tree_leaves, tree_map
    cfg = PPOConfig(num_steps=8, num_epochs=2, num_minibatches=2,
                    use_fused_kernels=True)
    n = 64
    out = {}
    for d in ("cpu", dev):
        env = make_env("Ant", megakernel=True, device=d)
        p, o, es, ob, _ = init_train(0, make_env("Ant", device="cpu"),
                                     env.spec.policy_dims, n, device="cpu")
        g = torch.Generator("cpu").manual_seed(1)
        noise = torch.randn((cfg.num_steps, n, env.spec.act_dim),
                            generator=g)
        perms = torch.stack([torch.randperm(cfg.num_steps * n, generator=g)
                             for _ in range(cfg.num_epochs)])
        p0 = [t.clone() for t in tree_leaves(p)]
        mv = lambda x: tree_map(lambda t: t.to(d), x)
        res = train_iteration(mv(p), mv(o), env, mv(es), ob.to(d), None,
                              cfg, noise=noise.to(d), perms=perms.to(d))
        out[str(d)] = tree_map(lambda t: t.cpu(), (res[0], res[5]))
    (pc, mc), (pg, mg) = out["cpu"], out[str(dev)]
    for k in ("loss", "reward_mean", "reward_sum", "episode_done_frac"):
        assert abs(float(mc[k]) - float(mg[k])) <= 1e-4, (k, mc[k], mg[k])
    moved = max(max_err(a, b) for a, b in zip(tree_leaves(pc), p0))
    assert moved > 1e-4, ("no update on the CPU", moved)
    perr = max(max_err(a, b) for a, b in zip(tree_leaves(pc),
                                             tree_leaves(pg)))
    assert perr <= 1e-5, perr
    return perr, moved


def check_small_a3c(dev):
    """Two small A3C rounds on the card (the n-step kernel, and the env
    megakernel into the ring or the ring-pack kernel) against the plain
    PyTorch path on the CPU, on both branches of ``round``, from the same
    params, Adam state, env states and noise.  Losses agree to 1e-4; the
    CPU run must move some param by more than 1e-4 (each round's single
    Adam step at lr = 3e-4 moves a param by up to ~3e-4) before the
    card's params are held to the CPU's within 1e-5."""
    from repro_torch.envs import make_env
    from repro_torch.rl.a3c import AsyncRunner
    from repro_torch.utils import tree_leaves, tree_map
    n, T = 64, 8
    res = {}
    for mk in (True, False):
        runs = {d: AsyncRunner(make_env("Ant", megakernel=mk, device=d),
                               [0, 1], [2], num_envs=n, num_steps=T, seed=0,
                               use_fused_kernels=True, device=d)
                for d in ("cpu", dev)}
        cpu, card = runs["cpu"], runs[dev]
        mv = lambda x: tree_map(lambda t: t.to(dev), x)
        card.params = card.actor_params = mv(cpu.params)
        card.opt_state = mv(cpu.opt_state)
        for a, (es, obs, _) in cpu.actors.items():
            card.actors[a] = [mv(es), obs.to(dev), card.actors[a][2]]
        p0 = [t.clone() for t in tree_leaves(cpu.params)]
        g = torch.Generator("cpu").manual_seed(1)
        act = cpu.env.spec.act_dim
        for _ in range(2):
            noise = {a: torch.randn((T, n, act), generator=g)
                     for a in cpu.serving_gmis}
            lc, sc = cpu.round(noise)
            lg, sg = card.round({a: x.to(dev) for a, x in noise.items()})
            assert sc == sg == [0], (sc, sg)
            assert max(abs(a - b) for a, b in zip(lc, lg)) <= 1e-4, (lc, lg)
        assert card.trained_samples == cpu.trained_samples == 2 * 2 * T * n
        moved = max(max_err(a, b) for a, b in zip(tree_leaves(cpu.params),
                                                  p0))
        assert moved > 1e-4, ("no update on the CPU", moved)
        perr = max(max_err(a, b.cpu()) for a, b in zip(
            tree_leaves(cpu.params), tree_leaves(card.params)))
        assert perr <= 1e-5, (mk, perr)
        res["direct" if mk else "push"] = (perr, moved)
    return res


def run_a3c(dev, megakernel: bool):
    """The A3C path at full width: ShadowHand, serving GMIs 0 and 1 of
    N_A3C envs each and trainer GMI 2 on one 2-slot ring, T = 16, fused
    n-step returns, A3C_ROUNDS rounds with the launch counters set to 0
    just before and read just after."""
    from repro_torch.envs import SPECS, make_env
    from repro_torch.kernels import ops
    from repro_torch.rl.a3c import AsyncRunner
    from repro_torch.utils import tree_leaves
    env = make_env(ENV, megakernel=megakernel, device=dev)
    runner = AsyncRunner(env, [0, 1], [2], num_envs=N_A3C, num_steps=T_MAIN,
                         seed=0, use_fused_kernels=True, device=dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    round_s, losses = [], []
    for _ in range(A3C_ROUNDS):
        ti = time.perf_counter()
        ls, stale = runner.round()       # reads the losses: a sync
        round_s.append(time.perf_counter() - ti)
        assert stale == [0] and len(ls) == 1, (stale, ls)
        assert all(v == v and abs(v) < float("inf") for v in ls), ls
        losses += ls
    elapsed = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    direct = 2 * T_MAIN * A3C_ROUNDS if megakernel else 0
    want = {"env_mega_step": direct, "gae_norm": 0, "policy_mlp": 0,
            "nstep_returns": A3C_ROUNDS,
            "pack_channels": 0 if megakernel else 2 * A3C_ROUNDS}
    assert launches == want, (launches, want)
    samples = A3C_ROUNDS * 2 * T_MAIN * N_A3C
    assert runner.trained_samples == runner.predictions == samples, (
        runner.trained_samples, runner.predictions)
    assert all(bool(p.isfinite().all()) for p in tree_leaves(runner.params))
    for es, obs, _ in runner.actors.values():
        assert obs.shape == (N_A3C, SPECS[ENV].obs_dim)
        assert bool(obs.isfinite().all())
    return launches, round_s, elapsed, losses, samples


# ------------------------------------------------------------- bounds ----
def env_bound(N, J, obs_dim, substeps):
    R = 6 + 4 * J + 3
    # reads q, qd, action (N,J) f32, root (N,6), t/seed/resets (N,) i32 and
    # the constants; writes q, qd, prev_action, root, t, resets, obs,
    # reward, done.  prev_action is an input the step never reads.
    bytes_ = 4 * (3 * N * J + 6 * N + 3 * N + R * obs_dim + 3 * J) \
        + 4 * (3 * N * J + 6 * N + 2 * N + N * obs_dim + 2 * N)
    # observation projection + tanh, and ~32 fp32 ops a joint a substep
    # (coupling, gravity, qdd, clip, Euler, tip cumsum, thrust sums,
    # counting each sin/cos as one) plus ~30 a substep for the root
    ops_ = 2 * N * R * obs_dim + N * obs_dim \
        + N * substeps * (32 * J + 30)
    return bytes_, ops_


def gae_bound(T, N):
    # reads r, v, d (T,N) and last (N); writes adv, ret (T,N); ~13 ops an
    # element (scan 7, mean and centred variance 4, normalise 2)
    return 4 * (3 * T * N + N + 2 * T * N), 13 * T * N


def trunk_bound(dims, N):
    pairs = list(zip(dims[:-1], dims[1:]))
    bytes_ = 4 * (N * dims[0] + sum(a * b + b for a, b in pairs)
                  + N * dims[-1])
    ops_ = sum(2 * N * a * b + 2 * N * b for a, b in pairs)
    return bytes_, ops_


def nstep_bound(T, N):
    # reads r, d (T,N) and bootstrap (N); writes G (T,N); 4 ops an element
    return 4 * (3 * T * N + N), 4 * T * N


def pack_bound(T, N, obs_dim, act_dim):
    # every payload element read once and written once; no arithmetic
    return 2 * (4 * (T * N * (obs_dim + act_dim + 2) + N) + 4), 0


def bound_ms(bytes_, ops_):
    tb, to = bytes_ / PEAK_BYTES * 1e3, ops_ / PEAK_F32 * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    sys.path.insert(0, src)
    from repro_torch.envs import SPECS, make_env
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.rl.ppo import PPOConfig, init_train, make_train_step
    from repro_torch.utils import tree_leaves

    # full fp32 matmuls: the plain versions must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "| card:", card_line())

    # 1. build ------------------------------------------------------------
    secs = _build.build_all()
    print(f"[build] {secs:.1f} s (0 = already built) in {_build.build_dir()}")
    for stem, log in _build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {stem}: {line.strip()}")

    # 2. kernel against plain version -------------------------------------
    gen = torch.Generator(dev).manual_seed(0)
    spec = SPECS[ENV]
    trunk_dims = spec.policy_dims[:-1]
    errs = {
        "env_mega_step": max(check_env(ENV, N_MAIN, gen, dev, False),
                             check_env(ENV, N_MAIN, gen, dev, True)),
        "gae_norm": check_gae(T_MAIN, N_MAIN, gen, dev),
        "policy_mlp": check_trunk(trunk_dims, N_MAIN, gen, dev),
        "nstep_returns": check_nstep(T_MAIN, N_MAIN, gen, dev),
        "pack_channels": check_pack(T_MAIN, N_A3C, spec, gen, dev, 3),
    }
    for k, e in errs.items():
        print(f"[check] {k} main-path shapes: max_abs_err={e:.3g} "
              f"(tol {TOL[k]:g})")
    for name, sp in SPECS.items():
        e1 = check_env(name, N_RAGGED, gen, dev, True)
        e2 = check_trunk(sp.policy_dims[:-1], N_RAGGED, gen, dev)
        print(f"[check] {name} N={N_RAGGED}: env max_abs_err={e1:.3g}, "
              f"trunk {sp.policy_dims[:-1]} max_abs_err={e2:.3g}")
    print(f"[check] gae_norm T=5 N={N_RAGGED}: max_abs_err="
          f"{check_gae(5, N_RAGGED, gen, dev):.3g}")
    print(f"[check] nstep_returns T=5 N={N_RAGGED}: max_abs_err="
          f"{check_nstep(5, N_RAGGED, gen, dev):.3g}")
    ver = torch.tensor([[11]], dtype=torch.int32, device=dev)
    print(f"[check] pack_channels T=5 N={N_PACK_RAGGED} (version tensor): "
          f"max_abs_err={check_pack(5, N_PACK_RAGGED, spec, gen, dev, ver)}"
          ", rings bit-exact, sentinel kept")

    # 3. small iteration against the CPU path -----------------------------
    perr, moved = check_small_iteration(dev)
    print(f"[parity] fused PPO iteration card vs CPU: params max_abs_err="
          f"{perr:.3g} (tol 1e-5; largest update {moved:.3g}), metrics "
          "within 1e-4")

    # 4. small A3C rounds against the CPU path ----------------------------
    for branch, (perr, moved) in check_small_a3c(dev).items():
        print(f"[parity] A3C {branch} branch, 2 rounds card vs CPU: params "
              f"max_abs_err={perr:.3g} (tol 1e-5; largest update "
              f"{moved:.3g}), losses within 1e-4, staleness [0]")

    # 5. the PPO path -------------------------------------------------------
    env = make_env(ENV, megakernel=True, device=dev)
    cfg = PPOConfig(num_steps=T_MAIN, use_fused_kernels=True)
    state = list(init_train(0, env, spec.policy_dims, N_MAIN, device=dev))
    step = make_train_step(env, cfg)
    iters = 3
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    it_s = []
    for _ in range(iters):
        ti = time.perf_counter()
        *state, metrics = step(*state)
        torch.cuda.synchronize()
        it_s.append(time.perf_counter() - ti)
        vals = {k: float(v) for k, v in metrics.items()}
        assert all(map(lambda v: v == v and abs(v) < float("inf"),
                       vals.values())), vals
    elapsed = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = {"env_mega_step": T_MAIN * iters, "policy_mlp": (T_MAIN + 1) * iters,
            "gae_norm": iters, "nstep_returns": 0, "pack_channels": 0}
    assert launches == want, (launches, want)
    by_path = {"ppo": launches}
    params, _, env_state, obs = state[:4]
    assert obs.shape == (N_MAIN, spec.obs_dim) and bool(obs.isfinite().all())
    assert all(bool(p.isfinite().all()) for p in tree_leaves(params))
    steps = iters * T_MAIN * N_MAIN
    print(f"[ppo] {ENV} N={N_MAIN} T={T_MAIN}: {iters} iterations, "
          f"per-iteration s={[round(s, 4) for s in it_s]}, "
          f"{steps / elapsed:,.0f} env steps/s, "
          f"{T_MAIN * N_MAIN / min(it_s):,.0f} env steps/s (best "
          f"iteration), last metrics {vals}, launches {launches}")

    # 6. the A3C path, both branches ----------------------------------------
    for branch, mk in (("a3c_direct", True), ("a3c_push", False)):
        la, round_s, el, losses, samples = run_a3c(dev, mk)
        by_path[branch] = la
        print(f"[a3c] {branch}: {ENV} 2 serving GMIs x N={N_A3C}, T={T_MAIN},"
              f" {A3C_ROUNDS} rounds, per-round s="
              f"{[round(x, 4) for x in round_s]}, {samples / el:,.0f} env "
              f"steps/s, {2 * T_MAIN * N_A3C / min(round_s):,.0f} env "
              f"steps/s (best round), trained == predicted == {samples:,}, "
              f"losses {[round(x, 4) for x in losses]}, staleness [0] a "
              f"round, launches {la}")
    launches = {k: sum(p[k] for p in by_path.values()) for k in TOL}

    # 7. timings ------------------------------------------------------------
    _, st, action, obs0, consts, kw = env_inputs(ENV, N_MAIN, gen, dev)
    r, v, d, last = gae_inputs(T_MAIN, N_MAIN, gen, dev)
    x, ws, bs = trunk_inputs(trunk_dims, N_MAIN, gen, dev)
    pay, bufs = pack_inputs(T_MAIN, 2, N_A3C, spec, gen, dev, 3)

    def chain():
        h = x
        for w, b in zip(ws, bs):
            h = torch.tanh(torch.addmm(b, h, w))
        return h

    def copies():
        col = N_A3C
        for c in ("obs", "actions", "rewards", "dones"):
            bufs[c][:, col:col + N_A3C].copy_(pay[c])
        bufs["bootstrap"][1].copy_(pay["bootstrap"])
        bufs["actor_version"][1].fill_(pay["actor_version"])

    rows = []
    timings = {
        "env_mega_step": (
            lambda: ops.env_mega_step(*st, action, obs0, None, 0, 0,
                                      *consts, **kw),
            lambda: ref.mega_step(*st, action, obs0, None, 0, 0, *consts,
                                  **kw),
            None, env_bound(N_MAIN, spec.act_dim, spec.obs_dim,
                            spec.substeps)),
        "gae_norm": (lambda: ops.gae_norm(r, v, d, last),
                     lambda: ref.gae_norm_ref(r, v, d, last), None,
                     gae_bound(T_MAIN, N_MAIN)),
        "policy_mlp": (lambda: ops.policy_mlp(x, ws, bs),
                       lambda: ref.policy_mlp_ref(x, ws, bs), chain,
                       trunk_bound(trunk_dims, N_MAIN)),
        "nstep_returns": (lambda: ops.nstep_returns(r, d, last),
                          lambda: ref.nstep_returns_ref(r, d, last), None,
                          nstep_bound(T_MAIN, N_MAIN)),
        "pack_channels": (lambda: ops.pack_channels(bufs, pay, 1),
                          lambda: ref.pack_channels_ref(bufs, pay, 1),
                          copies, pack_bound(T_MAIN, N_A3C, spec.obs_dim,
                                             spec.act_dim)),
    }
    for name, (kern, plain, lib, (nbytes, nops)) in timings.items():
        b_ms, b_by = bound_ms(nbytes, nops)
        # plain, kernel, kernel, plain: report the mean of each pair
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": (k1 + k2) / 2,
            "plain_ms": (p1 + p2) / 2, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lib) if lib else None,
            "bytes": nbytes, "ops": nops,
            "launches_by_path": {p: la[name] for p, la in by_path.items()}})
        print(f"[time] {name}: kernel {rows[-1]['ms']:.4f} ms, plain "
              f"{rows[-1]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), library {rows[-1]['library_ms']} ms")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
