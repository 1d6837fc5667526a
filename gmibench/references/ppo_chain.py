"""Plain float32 PyTorch reference of synchronous PPO over GMIs on the
articulated-chain envs: the env step (semi-implicit Euler chain physics,
reward, counter-based auto-reset, the sensor projection), the tanh-MLP
Gaussian policy with its value head, GAE with the advantages normalised
over the whole batch, the clipped-surrogate PPO loss and its gradient by
autograd, Adam with global-norm clipping, and the parameter average
across GMIs after every iteration.

It is written from the algorithms and the configuration file alone and
imports nothing of the program under test.  Matrix products run in
float32 with TF32 off (``precision="fp32"``).  The controls are the same
code with every product in TF32 (``"tf32"``) or with only the update's
products (the loss, its gradient) in TF32 (``"tf32_update"``);
``"fp64"`` runs everything in float64 from the same inputs, a witness of
how far float32's rounding alone takes the readings.  ``fault`` plants one
of the faults the comparison must catch: ``"half_batch"`` (each
minibatch's loss over its first half only) or ``"no_average"`` (the GMIs'
params never averaged).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch

PRECISIONS = ("fp32", "tf32", "tf32_update", "fp64")
FAULTS = ("half_batch", "no_average")


# ------------------------------------------------------------ precision ---
@contextlib.contextmanager
def matmul_precision(precision: str):
    """Float32 products with TF32 off (``"fp32"``, ``"fp64"``), or in TF32
    (``"tf32"``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _round_tf32(x):
    """``x`` rounded to TF32's 10-bit mantissa (nearest, ties away), as
    the tensor cores read a float32 operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Emulated(torch.autograd.Function):
    """A product of TF32-rounded operands, for devices without TF32 (the
    CPU); its gradient rounds the operands of the backward products too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _round_tf32(a) @ _round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        return g @ _round_tf32(b).T, _round_tf32(a).T @ g


def matmul_fn(precision: str, device: torch.device):
    """The product the reference uses: ``torch.matmul`` (under
    :func:`matmul_precision`), or on a device without TF32 its emulation."""
    if precision == "tf32" and device.type != "cuda":
        return _TF32Emulated.apply
    return torch.matmul


# ------------------------------------------------------------------ env ---
def sensor_matrix(env_name: str, raw_dim: int, obs_dim: int) -> np.ndarray:
    """The env's fixed projection from its raw state to its observation,
    seeded from Python's ``hash`` of the env's name (so the same in every
    process only under a fixed ``PYTHONHASHSEED``)."""
    seed = abs(hash(env_name)) % (2 ** 31)
    rng = np.random.RandomState(seed)
    m = rng.randn(raw_dim, obs_dim).astype(np.float32)
    q, _ = np.linalg.qr(m) if raw_dim >= obs_dim else np.linalg.qr(m.T)
    out = q[:, :obs_dim] if raw_dim >= obs_dim else q[:, :raw_dim].T
    return np.ascontiguousarray(out * np.sqrt(2.0))


class Env:
    """The constants of one chain env, from its configuration."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        e = cfg["env_model"]
        J = cfg["act_dim"]
        self.J = J
        self.dtype = dtype
        idx = torch.arange(J, dtype=dtype, device=device)
        self.masses = 1.0 + 0.15 * torch.cos(idx)
        self.lengths = 0.35 + 0.05 * torch.sin(1.7 * idx)
        self.inertia = self.masses * torch.square(self.lengths) + 1e-3
        self.tgt = torch.as_tensor(np.random.RandomState(
            e["target_seed"]).uniform(-0.6, 0.6, size=(J,)).astype(
                np.float32), device=device).to(dtype)
        raw_dim = 6 + 4 * J + 3
        self.sensor = torch.as_tensor(
            sensor_matrix(cfg["env"], raw_dim, cfg["obs_dim"]),
            dtype=torch.float32, device=device).to(dtype)
        self.chain = dict(e["chain"])
        self.task = dict(e["task"])
        self.substeps = int(e["substeps"])
        self.dt = float(e["dt"])
        self.max_len = int(e["max_episode_len"])


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _u32(x):
    return torch.as_tensor(x).to(torch.int64) & _M32


def _fmix32(x):
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def counter_normal(seed, counter, idx):
    """One standard normal per (seed, counter, idx): Murmur3's fmix32 of
    the three words, two 24-bit uniforms, Box-Muller."""
    s, c, i = _u32(seed), _u32(counter), _u32(idx)
    base = _fmix32(s ^ _mul32(c, 0x9E3779B9))
    h1 = _fmix32((base + i * 2 + 1) & _M32)
    h2 = _fmix32((base + i * 2 + 2) & _M32)
    u1 = (h1 >> 8).to(torch.float32) * (1.0 / 16777216.0) \
        + (0.5 / 16777216.0)
    u2 = (h2 >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def _tip(env: Env, q, root_z):
    return root_z + torch.sum(env.lengths * torch.cos(torch.cumsum(q, 1)), 1)


def observe(env: Env, st: dict, mm):
    q, qd, root = st["q"], st["qd"], st["root"]
    raw = torch.cat([root, torch.sin(q), torch.cos(q), qd, st["prev_action"],
                     torch.stack([_tip(env, q, root[:, 2]), root[:, 2] - 0.6,
                                  torch.mean(torch.abs(qd), 1)], 1)], 1)
    return torch.tanh(mm(raw, env.sensor))


def _fresh_q(env: Env, seed, resets):
    idx = torch.arange(env.J, dtype=torch.int64, device=seed.device)
    return 0.1 * counter_normal(seed[:, None], resets[:, None],
                                idx).to(env.dtype)


def reset(env: Env, seeds, mm=torch.matmul):
    """Fresh env state of per-env stream ids ``seeds`` (int32), and its
    observation."""
    n = seeds.shape[0]
    dev = seeds.device
    zeros = torch.zeros((n, env.J), dtype=env.dtype, device=dev)
    resets = torch.zeros((n,), dtype=torch.int32, device=dev)
    st = {"q": _fresh_q(env, seeds, resets), "qd": zeros,
          "root": torch.tensor([0., 0., 0.6, 0., 0., 0.], dtype=env.dtype,
                               device=dev).expand(n, 6).clone(),
          "prev_action": zeros.clone(),
          "t": torch.zeros((n,), dtype=torch.int32, device=dev),
          "seed": seeds.to(torch.int32), "resets": resets}
    return st, observe(env, st, mm)


def env_step(env: Env, st: dict, action, mm):
    """One env step: ``substeps`` semi-implicit Euler substeps of the
    chain, its reward, the episode bookkeeping, an auto-reset of every env
    that is done, and the observation.  Returns (state, obs, reward,
    done as float)."""
    c, w = env.chain, env.task
    a = torch.clamp(action, -1.0, 1.0)
    q, qd, root = st["q"], st["qd"], st["root"]
    h = env.dt / env.substeps
    for _ in range(env.substeps):
        left = torch.cat([q[:, :1], q[:, :-1]], 1)
        right = torch.cat([q[:, 1:], q[:, -1:]], 1)
        grav = c["gravity"] * env.masses * env.lengths * torch.sin(q)
        qdd = (c["torque_scale"] * a - c["damping"] * qd
               - c["stiffness"] * q - grav
               + c["coupling"] * (left - 2.0 * q + right)) / env.inertia
        qd = torch.clamp(qd + h * qdd, -c["max_qd"], c["max_qd"])
        q = q + h * qd
        pen = torch.clamp(-_tip(env, q, root[:, 2]), min=0.0)
        contact = c["ground_k"] * pen - c["ground_c"] * torch.clamp(
            root[:, 5], max=0.0) * (pen > 0)
        thrust = torch.stack([
            torch.mean(torch.sin(q) * a, 1) * c["torque_scale"],
            0.1 * torch.mean(torch.cos(2 * q) * a, 1),
            contact - c["gravity"] * 0.5], 1)
        vel = (root[:, 3:] + h * thrust) * (1.0 - 0.02)
        pos = root[:, :3] + h * vel
        pos = torch.cat([pos[:, :2], torch.clamp(pos[:, 2:3], min=0.05)], 1)
        root = torch.cat([pos, vel], 1)
    reward = (w["w_forward"] * root[:, 3]
              + w["w_upright"] * torch.cos(torch.mean(q, 1))
              - w["w_ctrl"] * torch.sum(torch.square(a), 1)
              - w["w_target"] * torch.mean(torch.square(q - env.tgt), 1)
              + 0.5)
    t = st["t"] + 1
    done = (t >= env.max_len) | (root[:, 2] < w["fall_z"])
    d = done[:, None]
    resets = torch.where(done, st["resets"] + 1, st["resets"]).to(
        torch.int32)
    root0 = torch.tensor([0., 0., 0.6, 0., 0., 0.], dtype=env.dtype,
                         device=q.device)
    new = {"q": torch.where(d, _fresh_q(env, st["seed"], st["resets"] + 1),
                            q),
           "qd": torch.where(d, 0.0, qd),
           "root": torch.where(d, root0, root),
           "prev_action": torch.where(d, 0.0, a),
           "t": torch.where(done, 0, t).to(torch.int32),
           "seed": st["seed"], "resets": resets}
    return new, observe(env, new, mm), reward, done.float()


# --------------------------------------------------------------- policy ---
def init_params(dims, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """He-normal weights (the mean head's scaled by 0.01), zero biases and
    log standard deviation, drawn on ``gen``'s device in one call.  Weights
    are (in, out)."""
    dev = gen.device
    shapes = [(dims[j], dims[j + 1]) for j in range(len(dims) - 2)]
    shapes += [(dims[-2], dims[-1]), (dims[-2], 1)]
    flat = torch.randn((sum(a * b for a, b in shapes),), generator=gen,
                       device=dev, dtype=torch.float32)
    ws = [x.view(s) * (2.0 / s[0]) ** 0.5 for x, s in zip(
        torch.split(flat, [a * b for a, b in shapes]), shapes)]
    out = {}
    for j in range(len(dims) - 2):
        out[f"trunk.{j}.w"] = ws[j].clone()
        out[f"trunk.{j}.b"] = torch.zeros((dims[j + 1],), device=dev)
    out["mu.w"] = ws[-2] * 0.01
    out["mu.b"] = torch.zeros((dims[-1],), device=dev)
    out["log_std"] = torch.zeros((dims[-1],), device=dev)
    out["value.w"] = ws[-1].clone()
    out["value.b"] = torch.zeros((1,), device=dev)
    return out


def policy(p: dict, obs, mm):
    """obs (n, in) -> (mu, log_std, value)."""
    h = obs
    j = 0
    while f"trunk.{j}.w" in p:
        h = torch.tanh(mm(h, p[f"trunk.{j}.w"]) + p[f"trunk.{j}.b"])
        j += 1
    mu = mm(h, p["mu.w"]) + p["mu.b"]
    value = (mm(h, p["value.w"]) + p["value.b"])[:, 0]
    return mu, p["log_std"].expand(mu.shape), value


def log_prob(mu, log_std, action):
    var = torch.exp(2 * log_std)
    return torch.sum(-0.5 * (torch.square(action - mu) / var + 2 * log_std
                             + math.log(2 * math.pi)), -1)


def entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), -1)


# ------------------------------------------------------------------ PPO ---
def gae_normalized(rewards, values, dones, last_value, gamma, lam,
                   eps=1e-8):
    """GAE over (T, n); returns (advantages normalised over the whole
    batch by their population std, returns)."""
    adv = torch.zeros_like(last_value)
    v_next = last_value
    advs = []
    for t in reversed(range(rewards.shape[0])):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * v_next * nonterm - values[t]
        adv = delta + gamma * lam * nonterm * adv
        advs.append(adv)
        v_next = values[t]
    advs = torch.stack(advs[::-1])
    returns = advs + values
    return (advs - advs.mean()) / (advs.std(correction=0) + eps), returns


class Adam:
    """Adam with global-norm clipping over a dict of float32 leaves."""

    def __init__(self, params: dict, ppo: dict):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.step = 0
        self.lr, self.clip = ppo["lr"], ppo["max_grad_norm"]
        a = ppo["adam"]
        self.b1, self.b2, self.eps = a["beta1"], a["beta2"], a["eps"]

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> dict:
        """Params after one step on ``grads``, the gradient as the
        optimizer gets it (clipped here)."""
        self.step += 1
        gn = torch.sqrt(sum(torch.sum(torch.square(g))
                            for g in grads.values()))
        scale = torch.clamp(self.clip / torch.clamp(gn, min=1e-12), max=1.0)
        # the bias corrections in the params' precision, as a float32 Adam
        # has them: 1 - 0.999 is 1.3e-5 off in float32
        t = torch.tensor(float(self.step), dtype=gn.dtype, device=gn.device)
        b1c = 1.0 - torch.pow(self.b1, t)
        b2c = 1.0 - torch.pow(self.b2, t)
        out = {}
        for k, p in params.items():
            g = grads[k] * scale
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * torch.square(g)
            out[k] = p - self.lr * (self.m[k] / b1c) / (
                torch.sqrt(self.v[k] / b2c) + self.eps)
        return out


def iteration(p: dict, opt: Adam, env: Env, st: dict, obs,
              gen: torch.Generator, ppo: dict, mm, fault=None,
              update_precision: str = "fp32", update_mm=None):
    """One PPO iteration of one GMI: ``num_steps`` env steps of the policy
    (its action noise drawn from ``gen``), GAE, then ``num_epochs`` epochs
    of ``num_minibatches`` Adam updates over a permutation drawn from
    ``gen``, their products by ``update_mm`` (``mm`` if None) under
    ``update_precision``.  Returns (params, state, obs, mean loss, the
    first update's gradient)."""
    T = ppo["num_steps"]
    traj = []
    with torch.no_grad():
        for _ in range(T):
            mu, log_std, value = policy(p, obs, mm)
            # drawn in float32 whatever the precision, as the program draws
            noise = torch.randn(mu.shape, generator=gen, device=mu.device,
                                dtype=torch.float32).to(mu.dtype)
            action = mu + torch.exp(log_std) * noise
            lp = log_prob(mu, log_std, action)
            st, nxt, reward, done = env_step(env, st, action, mm)
            traj.append((obs, action, lp, reward, done, value))
            obs = nxt
        o, a, lp, r, d, v = [torch.stack(x) for x in zip(*traj)]
        last_value = policy(p, obs, mm)[2]
        adv, ret = gae_normalized(r, v, d, last_value, ppo["gamma"],
                                  ppo["lam"])
    n = r.shape[1]
    flat = [x.reshape((T * n,) + x.shape[2:]) for x in (o, a, lp, adv, ret)]
    M = ppo["num_minibatches"]
    size = T * n // M
    mm_u = update_mm or mm
    epoch_losses, first = [], None
    for _ in range(ppo["num_epochs"]):
        perm = torch.randperm(T * n, generator=gen, device=gen.device)
        idx = perm.reshape(M, size)
        losses = []
        for m in range(M):
            rows = idx[m] if fault != "half_batch" else idx[m, :size // 2]
            bo, ba, blp, badv, bret = [x[rows] for x in flat]
            leaves = {k: x.detach().requires_grad_(True)
                      for k, x in p.items()}
            with matmul_precision(update_precision):
                mu, log_std, value = policy(leaves, bo, mm_u)
                ratio = torch.exp(log_prob(mu, log_std, ba) - blp)
                c = ppo["clip_eps"]
                pg = -torch.minimum(ratio * badv,
                                    torch.clamp(ratio, 1 - c, 1 + c) * badv)
                vf = 0.5 * torch.square(value - bret)
                loss = pg.mean() + ppo["vf_coef"] * vf.mean() \
                    - ppo["ent_coef"] * entropy(log_std).mean()
                grads = dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))))
            first = grads if first is None else first
            p = opt.update(p, grads)
            losses.append(loss.detach())
        epoch_losses.append(torch.stack(losses).mean())
    return p, st, obs, torch.stack(epoch_losses).mean(), first


def _norms(tree: dict) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(x.double()))
            for k, x in tree.items()}


def run(cfg: dict, traffic: dict, inputs: dict, device, iterations: int = 3,
        precision: str = "fp32", fault: Optional[str] = None) -> dict:
    """The first ``iterations`` iterations of every GMI from the
    benchmark's ``inputs`` (``params``, ``env_seeds``, ``gen_seeds``), the
    params averaged after each.  Returns the readings the comparison
    takes: each iteration's loss per GMI; after the first iteration every
    env's observation, each GMI's first gradient as its optimizer got it
    and its Adam first moment (norms per leaf); and the change of GMI 0's
    params over all ``iterations`` (norm per leaf)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    device = torch.device(device)
    k, n = traffic["gmis"], traffic["envs_per_gmi"]
    ppo = cfg["ppo"]
    act = "fp32" if precision == "tf32_update" else precision
    upd = "tf32" if precision == "tf32_update" else precision
    mm, mm_u = matmul_fn(act, device), matmul_fn(upd, device)
    dtype = torch.float64 if precision == "fp64" else torch.float32
    with matmul_precision(act):
        env = Env(cfg, device, dtype)
        st_all, obs_all = reset(env, inputs["env_seeds"].to(device), mm)
        p0 = {key: x.to(device, dtype) for key, x in
              inputs["params"].items()}
        gmis = []
        for i in range(k):
            rows = slice(i * n, (i + 1) * n)
            gen = torch.Generator(device).manual_seed(inputs["gen_seeds"][i])
            gmis.append([dict(p0), Adam(p0, ppo),
                         {key: x[rows] for key, x in st_all.items()},
                         obs_all[rows], gen])
        losses, firsts, moments, obs = [], [], None, None
        for it in range(iterations):
            row = []
            for g in gmis:
                g[0], g[2], g[3], loss, first = iteration(
                    g[0], g[1], env, g[2], g[3], g[4], ppo, mm, fault,
                    upd, mm_u)
                row.append(float(loss))
                if it == 0:
                    firsts.append(_norms(first))
            losses.append(row)
            if it == 0:
                moments = [_norms(g[1].m) for g in gmis]
                obs = torch.cat([g[3] for g in gmis]).cpu().numpy()
            if k > 1 and fault != "no_average":
                mean = {key: sum(g[0][key] for g in gmis) / k for key in p0}
                for g in gmis:
                    g[0] = mean
        change = _norms({key: gmis[0][0][key] - p0[key] for key in p0})
    return {"loss": losses, "obs": obs, "grad": firsts, "moment": moments,
            "change": change}
