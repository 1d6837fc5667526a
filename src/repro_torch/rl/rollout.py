"""Experience collection: the serving loop (simulator <-> agent
interaction), port of ``repro/rl/rollout.py``.

``collect`` is the paper's "DRL serving block": per step the policy acts,
then the vectorized env advances.  A Python loop stands in for the
reference's ``lax.scan``.  With ``policy_fn=policy_apply_fused`` (what PPO
passes when ``use_fused_kernels`` is set) the acting trunk runs on the
fused kernel, and with ``VectorEnv(megakernel=True)`` the env step runs on
the env megakernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.policy import log_prob, policy_apply, sample_action


class Trajectory(NamedTuple):
    obs: torch.Tensor        # (T, N, obs_dim)
    actions: torch.Tensor    # (T, N, act_dim)
    log_probs: torch.Tensor  # (T, N)
    rewards: torch.Tensor    # (T, N)
    dones: torch.Tensor      # (T, N)
    values: torch.Tensor     # (T, N)


@torch.no_grad()
def collect(policy_params, env, env_state, obs, gen: torch.Generator,
            num_steps: int, policy_fn=policy_apply,
            noise: Optional[torch.Tensor] = None):
    """Roll the policy for ``num_steps`` across all vectorized envs.

    The Gaussian action noise is ``noise[t]`` when ``noise`` (T, N, act) is
    given, else drawn from ``gen``.  Returns (traj, env_state, last_obs,
    last_value)."""
    outs = []
    for t in range(num_steps):
        mu, log_std, value = policy_fn(policy_params, obs)
        eps = noise[t] if noise is not None else torch.randn(
            mu.shape, generator=gen, device=mu.device)
        action = sample_action(mu, log_std, eps)
        lp = log_prob(mu, log_std, action)
        env_state, next_obs, reward, done = env.step(env_state, action)
        outs.append((obs, action, lp, reward, done.float(), value))
        obs = next_obs
    traj = Trajectory(*[torch.stack(x) for x in zip(*outs)])
    _, _, last_value = policy_fn(policy_params, obs)
    return traj, env_state, obs, last_value


def gae(rewards, values, dones, last_value, gamma: float = 0.99,
        lam: float = 0.95):
    """Generalized advantage estimation.  All inputs (T, N)."""
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
    return advs, advs + values


def gae_fused(rewards, values, dones, last_value, gamma: float = 0.99,
              lam: float = 0.95, eps: float = 1e-8):
    """Fused GAE: one kernel computes the reverse scan, the returns AND the
    global advantage normalization.  Returns (normalized_advs, returns);
    callers must not re-normalize per minibatch."""
    from repro_torch.kernels import ops
    return ops.gae_norm(rewards, values, dones, last_value, gamma=gamma,
                        lam=lam, eps=eps)
