#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's main path (sync PPO).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (PATH or /usr/local/cuda/bin).  Phases,
each asserting, in order:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (all sources in
   parallel) and print the build time, nvcc's register/spill report and
   the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (ShadowHand, N = 16384, a share of envs forced to
   reset; the env megakernel without and with ring writes; GAE at
   T = 16, N = 16384; the trunk at 16384 x 211 -> 256) and at every
   Table-6 env and trunk width at a ragged N;
3. check one small fused PPO iteration on the card against the plain
   PyTorch path on the CPU from the same params, state, noise and
   permutations;
4. drive the main path: ``make_env("ShadowHand", megakernel=True)`` and
   ``PPOConfig(num_steps=16, use_fused_kernels=True)`` at N = 16384 for
   3 iterations, with the launch counters set to 0 just before and read
   just after;
5. time each kernel, its plain version and (for the trunk) the
   ``addmm``+``tanh`` chain with CUDA events, and print one
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
PEAK_BYTES = 3.35e12     # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12         # H100 SXM fp32 outside the tensor cores, flop/s
TOL = {"env_mega_step": 1e-4, "gae_norm": 1e-4, "policy_mlp": 1e-4}
KERNELS = {
    "env_mega_step": ("src/repro_torch/csrc/env_megakernel.cu",
                      "src/repro/kernels/env_megakernel.py:179"),
    "gae_norm": ("src/repro_torch/csrc/gae_scan.cu",
                 "src/repro/kernels/gae_scan.py:57"),
    "policy_mlp": ("src/repro_torch/csrc/fused_policy_mlp.cu",
                   "src/repro/kernels/fused_policy_mlp.py:37"),
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


def ring(T, S, n, env, dev, fill=-7.0):
    sp = env.spec
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


# ------------------------------------------------------------- checks ----
def check_env(name, n, gen, dev, with_ring: bool) -> float:
    from repro_torch.kernels import ops, ref
    env, state, action, obs, consts, kw = env_inputs(name, n, gen, dev)
    T, S, slot, step_t = 4, 2, 1, 2
    bk = ring(T, S, n, env, dev) if with_ring else None
    br = ring(T, S, n, env, dev) if with_ring else None
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

    # 3. small iteration against the CPU path -----------------------------
    perr, moved = check_small_iteration(dev)
    print(f"[parity] fused PPO iteration card vs CPU: params max_abs_err="
          f"{perr:.3g} (tol 1e-5; largest update {moved:.3g}), metrics "
          "within 1e-4")

    # 4. the main path ------------------------------------------------------
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
            "gae_norm": iters}
    assert launches == want, (launches, want)
    params, _, env_state, obs = state[:4]
    assert obs.shape == (N_MAIN, spec.obs_dim) and bool(obs.isfinite().all())
    assert all(bool(p.isfinite().all()) for p in tree_leaves(params))
    steps = iters * T_MAIN * N_MAIN
    print(f"[ppo] {ENV} N={N_MAIN} T={T_MAIN}: {iters} iterations, "
          f"per-iteration s={[round(s, 4) for s in it_s]}, "
          f"{steps / elapsed:,.0f} env steps/s, "
          f"{T_MAIN * N_MAIN / min(it_s):,.0f} env steps/s (best "
          f"iteration), last metrics {vals}, launches {launches}")

    # 5. timings ------------------------------------------------------------
    _, st, action, obs0, consts, kw = env_inputs(ENV, N_MAIN, gen, dev)
    r, v, d, last = gae_inputs(T_MAIN, N_MAIN, gen, dev)
    x, ws, bs = trunk_inputs(trunk_dims, N_MAIN, gen, dev)

    def chain():
        h = x
        for w, b in zip(ws, bs):
            h = torch.tanh(torch.addmm(b, h, w))
        return h

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
            "bytes": nbytes, "ops": nops})
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
