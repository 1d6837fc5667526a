"""The paper's six DRL benchmarks (Table 6) as batched PyTorch environments
(port of ``repro/envs/suite.py``).

| name          | abbr | type | obs | policy (Table 6)        | act |
| Ant           | AT   | L    |  60 | 60:256:128:64:8         |  8  |
| Anymal        | AY   | L    |  48 | 48:256:128:64:12        | 12  |
| BallBalance   | BB   | L    |  24 | 24:256:128:64:3         |  3  |
| FrankaCabinet | FC   | F    |  23 | 23:256:128:64:9         |  9  |
| Humanoid      | HM   | L    | 108 | 108:200:400:100:21      | 21  |
| ShadowHand    | SH   | R    | 211 | 211:512:512:512:256:20  | 20  |
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.envs.base import EnvSpec, EnvState, MegaConsts, VectorEnv
from repro_torch.envs.physics import (ChainParams, counter_normal,
                                      default_params, rollout_substeps,
                                      tip_height)
from repro_torch.utils import resolve_device

SPECS = {
    "Ant":           EnvSpec("Ant", "AT", 60, 8, "L", (60, 256, 128, 64, 8)),
    "Anymal":        EnvSpec("Anymal", "AY", 48, 12, "L", (48, 256, 128, 64, 12)),
    "BallBalance":   EnvSpec("BallBalance", "BB", 24, 3, "L", (24, 256, 128, 64, 3)),
    "FrankaCabinet": EnvSpec("FrankaCabinet", "FC", 23, 9, "F", (23, 256, 128, 64, 9)),
    "Humanoid":      EnvSpec("Humanoid", "HM", 108, 21, "L", (108, 200, 400, 100, 21)),
    "ShadowHand":    EnvSpec("ShadowHand", "SH", 211, 20, "R", (211, 512, 512, 512, 256, 20)),
}

_TASK = {
    # (w_forward, w_upright, w_ctrl, w_target, fall_z)
    "Ant":           (1.0, 0.2, 0.005, 0.0, 0.12),
    "Anymal":        (1.0, 0.4, 0.01, 0.0, 0.15),
    "BallBalance":   (0.0, 0.0, 0.002, 1.0, -1.0),
    "FrankaCabinet": (0.0, 0.0, 0.005, 1.5, -1.0),
    "Humanoid":      (1.2, 0.6, 0.01, 0.0, 0.25),
    "ShadowHand":    (0.0, 0.0, 0.002, 2.0, -1.0),
}


def _sensor_matrix(name: str, raw_dim: int, obs_dim: int) -> np.ndarray:
    """Fixed orthonormal-ish projection raw -> obs.  Seeded from Python's
    per-process ``hash(name)`` exactly as the reference does, so the two
    packages agree within one process (and only there)."""
    seed = abs(hash(name)) % (2 ** 31)
    rng = np.random.RandomState(seed)
    m = rng.randn(raw_dim, obs_dim).astype(np.float32)
    q, _ = np.linalg.qr(m) if raw_dim >= obs_dim else np.linalg.qr(m.T)
    out = q[:, :obs_dim] if raw_dim >= obs_dim else q[:, :raw_dim].T
    return np.ascontiguousarray(out * np.sqrt(2.0))


def mega_consts(name: str, device) -> MegaConsts:
    """The constant operands of env family ``name`` on ``device``."""
    J = SPECS[name].act_dim
    p = default_params(J, device=device)
    tgt = np.random.RandomState(7).uniform(-0.6, 0.6, size=(J,)).astype(
        np.float32)
    raw_dim = 6 + 4 * J + 3          # root + sinq/cosq/qd/prev_act + extras
    sensor = _sensor_matrix(name, raw_dim, SPECS[name].obs_dim)
    return MegaConsts(
        sensor=torch.as_tensor(sensor, dtype=torch.float32, device=device),
        tgt=torch.as_tensor(tgt, device=device), masses=p.masses,
        lengths=p.lengths,
        chain=(p.damping, p.coupling, p.stiffness, p.max_qd, p.gravity,
               p.torque_scale, p.ground_k, p.ground_c),
        task=_TASK[name])


def build_env(spec: EnvSpec, mega: MegaConsts,
              megakernel: bool = False) -> VectorEnv:
    """A ``VectorEnv`` whose both step paths read the constants ``mega``."""
    J = spec.act_dim
    device = mega.sensor.device
    params = ChainParams(mega.masses, mega.lengths, *mega.chain)
    w_fwd, w_up, w_ctrl, w_tgt, fall_z = mega.task
    idx = torch.arange(J, dtype=torch.int64, device=device)
    root0 = torch.tensor([0., 0., 0.6, 0., 0., 0.], device=device)

    def reset_fn(seed, resets) -> EnvState:
        # fresh state as a pure function of (seed, resets): shared with the
        # megakernel's predicated in-kernel reset, draw for draw
        n = seed.shape[0]
        q0 = 0.1 * counter_normal(seed[:, None], resets[:, None], idx)
        zeros = torch.zeros((n, J), device=device)
        return EnvState(
            q=q0, qd=zeros, root=root0.expand(n, 6).clone(),
            prev_action=zeros.clone(),
            t=torch.zeros((n,), dtype=torch.int32, device=device),
            seed=seed.to(torch.int32), resets=resets.to(torch.int32))

    def obs_fn(state: EnvState):
        tip = tip_height(state.q, state.root[:, 2], params)
        raw = torch.cat([
            state.root,
            torch.sin(state.q), torch.cos(state.q), state.qd,
            state.prev_action,
            torch.stack([tip, state.root[:, 2] - 0.6,
                         torch.mean(torch.abs(state.qd), dim=1)], dim=1),
        ], dim=1)
        return torch.tanh(raw @ mega.sensor)

    def step_fn(state: EnvState, action):
        a = torch.clamp(action, -1.0, 1.0)
        q, qd, root = rollout_substeps(state.q, state.qd, state.root, a,
                                       params, spec.dt, spec.substeps)
        upright = torch.cos(torch.mean(q, dim=1))
        reward = (w_fwd * root[:, 3]
                  + w_up * upright
                  - w_ctrl * torch.sum(torch.square(a), dim=1)
                  - w_tgt * torch.mean(torch.square(q - mega.tgt), dim=1)
                  + 0.5)                                   # alive bonus
        t = state.t + 1
        fell = root[:, 2] < fall_z
        done = (t >= spec.max_episode_len) | fell
        new_state = EnvState(q=q, qd=qd, root=root, prev_action=a, t=t,
                             seed=state.seed, resets=state.resets)
        return new_state, reward, done

    return VectorEnv(spec, reset_fn, step_fn, obs_fn, mega=mega,
                     megakernel=megakernel)


def make_env(name: str, megakernel: bool = False,
             device="cuda") -> VectorEnv:
    device = resolve_device(device)
    return build_env(SPECS[name], mega_consts(name, device), megakernel)


def all_env_names():
    return list(SPECS.keys())
