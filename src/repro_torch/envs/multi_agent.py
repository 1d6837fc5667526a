"""Multi-agent env family: K agents sharing one chain world (port of
``repro/envs/multi_agent.py``).

A *world* is one articulated chain of ``K * act_dim`` joints whose root
body every agent shares.  Agent ``k`` drives the joint block
``[k*J, (k+1)*J)``; the chain's neighbour coupling links each agent's
boundary joint to the next agent's, so actions propagate through the
shared dynamics.  Each agent observes the shared root plus its own joint
block through the single-agent sensor projection, so ``raw_dim``, the
observation and the Table-6 policy are those of the single-agent family:
one policy serves any K, and ``num_envs`` counts agents.

A world-level ``done`` (episode cap or root fall) resets all K agents
together, from ``(seed, resets + 1)`` as in ``envs/base.py``.  Every state
field carries a leading world dimension W = num_envs / K, which stands in
for the reference's ``vmap`` over worlds.  The family runs the plain step
only: ``with_megakernel(True)`` raises, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.envs.base import EnvState, derive_seeds
from repro_torch.envs.physics import (counter_normal, default_params,
                                      rollout_substeps, tip_height)
from repro_torch.envs.suite import SPECS, _TASK, _sensor_matrix
from repro_torch.utils import resolve_device


class MultiAgentVectorEnv:
    """The ``VectorEnv`` surface (``reset``/``step`` over (num_envs, ...)
    agent-major tensors), with agents in groups of ``num_agents`` sharing a
    world.  The state is per world: (W, K*J) joints, (W, 6) root."""

    megakernel = False

    def __init__(self, name: str, num_agents: int = 2, device="cuda"):
        assert num_agents >= 1
        self.device = resolve_device(device)
        spec = SPECS[name]
        self.spec = spec
        self.num_agents = K = int(num_agents)
        J = spec.act_dim
        self._Jw = Jw = K * J
        self._params = default_params(Jw, device=self.device)
        self._task = _TASK[name]
        self.tgt = torch.as_tensor(np.random.RandomState(7).uniform(
            -0.6, 0.6, size=(J,)).astype(np.float32), device=self.device)
        raw_dim = 6 + 4 * J + 3
        self.sensor = torch.as_tensor(
            _sensor_matrix(name, raw_dim, spec.obs_dim), dtype=torch.float32,
            device=self.device)
        self._idx = torch.arange(Jw, dtype=torch.int64, device=self.device)
        self._root0 = torch.tensor([0., 0., 0.6, 0., 0., 0.],
                                   device=self.device)

    # ------------------------------------------------------------ worlds --
    def _reset_worlds(self, seed, resets) -> EnvState:
        W = seed.shape[0]
        q0 = 0.1 * counter_normal(seed[:, None], resets[:, None], self._idx)
        zeros = torch.zeros((W, self._Jw), device=self.device)
        return EnvState(
            q=q0, qd=zeros, root=self._root0.expand(W, 6).clone(),
            prev_action=zeros.clone(),
            t=torch.zeros((W,), dtype=torch.int32, device=self.device),
            seed=seed.to(torch.int32), resets=resets.to(torch.int32))

    def _obs(self, state: EnvState):
        """(W*K, obs_dim): the shared root and each agent's joint block
        through the single-agent sensor projection."""
        W, K, J = state.q.shape[0], self.num_agents, self.spec.act_dim
        qk = state.q.reshape(W, K, J)
        qdk = state.qd.reshape(W, K, J)
        pak = state.prev_action.reshape(W, K, J)
        tip = tip_height(state.q, state.root[:, 2], self._params)
        ones = torch.ones((W, K), device=self.device)
        raw = torch.cat([
            state.root[:, None].expand(W, K, 6),
            torch.sin(qk), torch.cos(qk), qdk, pak,
            torch.stack([tip[:, None] * ones,
                         (state.root[:, 2:3] - 0.6) * ones,
                         torch.mean(torch.abs(qdk), dim=2)], dim=2),
        ], dim=2)
        return torch.tanh(raw @ self.sensor).reshape(W * K, -1)

    def _step_worlds(self, state: EnvState, action):
        """action (W, K*J) -> (state, reward (W, K), done (W,))."""
        W, K, J = state.q.shape[0], self.num_agents, self.spec.act_dim
        w_fwd, w_up, w_ctrl, w_tgt, fall_z = self._task
        a = torch.clamp(action, -1.0, 1.0)
        q, qd, root = rollout_substeps(state.q, state.qd, state.root, a,
                                       self._params, self.spec.dt,
                                       self.spec.substeps)
        qk = q.reshape(W, K, J)
        ak = a.reshape(W, K, J)
        reward = (w_fwd * root[:, 3:4]
                  + w_up * torch.cos(torch.mean(qk, dim=2))
                  - w_ctrl * torch.sum(torch.square(ak), dim=2)
                  - w_tgt * torch.mean(torch.square(qk - self.tgt), dim=2)
                  + 0.5)
        t = state.t + 1
        done = (t >= self.spec.max_episode_len) | (root[:, 2] < fall_z)
        new_state = EnvState(q=q, qd=qd, root=root, prev_action=a, t=t,
                             seed=state.seed, resets=state.resets)
        # materialized world reset, selected by the world's done
        fresh = self._reset_worlds(new_state.seed, new_state.resets + 1)
        out = EnvState(*[
            torch.where(done.view((-1,) + (1,) * (x.dim() - 1)), y, x)
            for x, y in zip(new_state, fresh)])
        return out, reward, done

    # --------------------------------------------------------- interface --
    def _check(self, num_envs: int) -> int:
        if num_envs % self.num_agents:
            raise ValueError(
                f"num_envs={num_envs} must be a multiple of "
                f"num_agents={self.num_agents} (agents share worlds)")
        return num_envs // self.num_agents

    def with_megakernel(self, flag: bool = True) -> "MultiAgentVectorEnv":
        if flag:
            raise ValueError("the multi-agent family is vmap-only; the "
                             "megakernel path rides the single-agent "
                             "suite (envs.make_env(megakernel=True))")
        return self

    def reset(self, gen: torch.Generator, num_envs: int):
        """World seeds from ``gen``; returns (state per world, obs
        (num_envs, obs_dim))."""
        W = self._check(num_envs)
        seeds = derive_seeds(gen, W)
        state = self._reset_worlds(seeds, torch.zeros_like(seeds))
        return state, self._obs(state)

    def step(self, state: EnvState, action):
        """action (num_envs, act_dim) agent-major -> (state, obs, reward,
        done), the per-agent views of the shared-world transition (done is
        the world's, repeated for its K agents)."""
        W = state.q.shape[0]
        K = self.num_agents
        state, reward, done = self._step_worlds(
            state, action.reshape(W, K * self.spec.act_dim))
        return (state, self._obs(state), reward.reshape(-1),
                torch.repeat_interleave(done, K))


def make_multi_agent_env(name: str, num_agents: int = 2,
                         device="cuda") -> MultiAgentVectorEnv:
    """K-agent shared-world variant of ``suite.make_env(name)``, on the
    card unless ``device`` says otherwise."""
    return MultiAgentVectorEnv(name, num_agents, device)
