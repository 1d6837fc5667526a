"""PPO (Schulman et al., arXiv:1707.06347) — the paper's synchronized DRL
training workload, port of ``repro/rl/ppo.py``.

One ``train_iteration`` = experience collection (m simulator-agent rounds)
+ minibatched clipped-surrogate updates with Adam.  The loss runs
``policy_apply`` under autograd; with ``use_fused_kernels`` the acting
trunk, the GAE and (with a megakernel env) the env step run on the CUDA
kernels.  ``grad_sync_fn`` is a callable on the gradient dict or a
``repro_torch.comm.Communicator``, identity by default.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.comm.api import as_grad_sync
from repro_torch.models.policy import (entropy, log_prob, policy_apply,
                                       policy_apply_fused)
from repro_torch.optim import AdamState, adam_init, adam_update
from repro_torch.rl.rollout import collect, gae, gae_fused
from repro_torch.utils import resolve_device, tree_flatten, tree_unflatten


class PPOConfig(NamedTuple):
    num_steps: int = 32          # m: simulator-agent rounds per iteration
    num_epochs: int = 4
    num_minibatches: int = 4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 1.0
    # fused hot path: fused GAE+normalization kernel, acting trunk on the
    # fused MLP kernel, and single-gather minibatches (advantages arrive
    # batch-normalized, so the loss skips its per-minibatch renormalization)
    use_fused_kernels: bool = False


def ppo_loss(params, batch, clip_eps, vf_coef, ent_coef,
             policy_fn=policy_apply, normalize_adv: bool = True):
    obs, actions, old_lp, advs, returns = batch
    mu, log_std, value = policy_fn(params, obs)
    lp = log_prob(mu, log_std, actions)
    ratio = torch.exp(lp - old_lp)
    advs_n = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8) \
        if normalize_adv else advs
    pg = -torch.minimum(ratio * advs_n,
                        torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps)
                        * advs_n)
    vf = 0.5 * torch.square(value - returns)
    ent = entropy(log_std)
    loss = pg.mean() + vf_coef * vf.mean() - ent_coef * ent.mean()
    return loss, (pg.mean(), vf.mean(), ent.mean())


def loss_and_grads(params, batch, cfg: PPOConfig, policy_fn=policy_apply):
    """(loss, grads) of :func:`ppo_loss` at ``params``; grads share the
    params' tree structure."""
    leaves, spec = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    loss, _ = ppo_loss(tree_unflatten(leaves, spec), batch, cfg.clip_eps,
                       cfg.vf_coef, cfg.ent_coef, policy_fn,
                       not cfg.use_fused_kernels)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(list(grads), spec)


def train_iteration(params, opt_state: AdamState, env, env_state, obs,
                    gen: torch.Generator, cfg: PPOConfig,
                    grad_sync_fn: Optional[Callable] = None,
                    policy_fn=policy_apply, noise=None, perms=None):
    """One full PPO iteration.  Returns (params, opt_state, env_state, obs,
    gen, metrics).  Random draws come from ``gen`` unless the caller passes
    them: ``noise`` (T, N, act) for the action noise and ``perms``
    (epochs, T*N) for the minibatch permutations.  ``grad_sync_fn`` may be
    a closure or a Communicator."""
    grad_sync_fn = as_grad_sync(grad_sync_fn)
    act_fn = policy_apply_fused if (cfg.use_fused_kernels
                                    and policy_fn is policy_apply) \
        else policy_fn
    traj, env_state, obs, last_value = collect(
        params, env, env_state, obs, gen, cfg.num_steps, act_fn, noise)
    if cfg.use_fused_kernels:
        # fused kernel: advantages arrive normalized over the batch
        advs, returns = gae_fused(traj.rewards, traj.values, traj.dones,
                                  last_value, cfg.gamma, cfg.lam)
    else:
        advs, returns = gae(traj.rewards, traj.values, traj.dones,
                            last_value, cfg.gamma, cfg.lam)

    T, N = traj.rewards.shape
    flat = [x.reshape((T * N,) + x.shape[2:]) for x in
            (traj.obs, traj.actions, traj.log_probs, advs, returns)]
    M = cfg.num_minibatches
    mb_size = (T * N) // M
    epoch_losses = []
    for e in range(cfg.num_epochs):
        perm = perms[e] if perms is not None else torch.randperm(
            T * N, generator=gen, device=gen.device)
        if cfg.use_fused_kernels:
            # single gather straight into minibatch layout
            idx = perm.reshape(M, mb_size)
            mbs = [x[idx] for x in flat]
        else:
            mbs = [x[perm].reshape((M, mb_size) + x.shape[1:])
                   for x in flat]
        losses = []
        for m in range(M):
            loss, grads = loss_and_grads(params, [x[m] for x in mbs], cfg,
                                         policy_fn)
            if grad_sync_fn is not None:
                grads = grad_sync_fn(grads)
            params, opt_state = adam_update(
                grads, opt_state, params, lr=cfg.lr, beta1=0.9, beta2=0.999,
                grad_clip=cfg.max_grad_norm)
            losses.append(loss)
        epoch_losses.append(torch.stack(losses).mean())

    metrics = {
        "loss": torch.stack(epoch_losses).mean(),
        "reward_mean": traj.rewards.mean(),
        "reward_sum": traj.rewards.sum(0).mean(),
        "episode_done_frac": traj.dones.mean(),
        "steps": torch.tensor(float(T * N), device=traj.rewards.device),
    }
    return params, opt_state, env_state, obs, gen, metrics


def make_train_step(env, cfg: PPOConfig, grad_sync_fn=None,
                    policy_fn=policy_apply):
    """A PPO iteration bound to an env instance and config.
    ``grad_sync_fn`` may be a closure or a Communicator, resolved once
    here."""
    grad_sync_fn = as_grad_sync(grad_sync_fn)

    def step(params, opt_state, env_state, obs, gen, noise=None, perms=None):
        return train_iteration(params, opt_state, env, env_state, obs, gen,
                               cfg, grad_sync_fn, policy_fn, noise, perms)
    return step


def init_train(seed: int, env, policy_dims, num_envs: int, device="cuda"):
    """Fresh params, Adam state and env state on ``device``.  Returns
    (params, opt_state, env_state, obs, gen): ``gen`` is the generator the
    draws came from, ready to drive ``train_iteration``."""
    from repro_torch.models.policy import init_policy
    device = resolve_device(device)
    if env.device != device:
        raise ValueError(f"env lives on {env.device}, init_train asked for "
                         f"{device}")
    gen = torch.Generator(device).manual_seed(seed)
    params = init_policy(gen, policy_dims)
    opt_state = adam_init(params)
    env_state, obs = env.reset(gen, num_envs)
    return params, opt_state, env_state, obs, gen
