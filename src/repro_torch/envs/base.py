"""Vectorized environment API (port of ``repro/envs/base.py``).

All state is batched: every ``EnvState`` field carries a leading ``N``
dimension, which stands in for the reference's ``vmap``.  Env randomness is
counter-based (``physics.counter_normal``): a fresh post-``done`` state is a
pure function of ``(seed, resets + 1)``, so the materialized auto-reset of
the default path and the predicated reset of the megakernel path agree
exactly.

``VectorEnv(megakernel=True).step`` goes through ``ops.env_mega_step``
(no ring): on a CUDA tensor that launches the hand-written env megakernel,
the counterpart of the reference's fused ``mega_step`` program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch


class EnvState(NamedTuple):
    q: torch.Tensor            # (N, J) joint angles
    qd: torch.Tensor           # (N, J) joint velocities
    root: torch.Tensor         # (N, 6) x, y, z, vx, vy, vz
    prev_action: torch.Tensor  # (N, J)
    t: torch.Tensor            # (N,) int32 step counter
    seed: torch.Tensor         # (N,) int32 per-env PRNG stream id
    resets: torch.Tensor       # (N,) int32 auto-reset counter


@dataclass(frozen=True)
class EnvSpec:
    name: str
    abbr: str
    obs_dim: int
    act_dim: int
    env_type: str                 # L (locomotion) | F (franka) | R (robotic hand)
    policy_dims: tuple            # paper Table 6
    max_episode_len: int = 1000
    substeps: int = 4
    dt: float = 1.0 / 60.0


@dataclass(frozen=True)
class MegaConsts:
    """Constant operands of the fused env step (megakernel + oracle)."""
    sensor: torch.Tensor  # (raw_dim, obs_dim) fixed sensor projection
    tgt: torch.Tensor     # (J,) task target configuration
    masses: torch.Tensor  # (J,) chain link masses
    lengths: torch.Tensor # (J,) chain link lengths
    chain: tuple          # (damping, coupling, stiffness, max_qd, gravity,
                          #  torque_scale, ground_k, ground_c)
    task: tuple           # (w_forward, w_upright, w_ctrl, w_target, fall_z)


def derive_seeds(gen: torch.Generator, num_envs: int):
    """Per-env int32 stream ids from one generator (reset-time only)."""
    return torch.randint(0, 2 ** 31 - 1, (num_envs,), generator=gen,
                         device=gen.device, dtype=torch.int32)


class VectorEnv:
    """Batched env: every method operates on (N, ...) states.

    ``megakernel=False`` (default): ``step_fn`` over the batch with a
    *materialized* auto-reset (a fresh state is computed for every env every
    step and selected by ``torch.where(done)``).

    ``megakernel=True``: ``step`` runs the fused env step
    (``ops.env_mega_step``): substeps + reward + bookkeeping + predicated
    reset + observation in one kernel launch on a CUDA tensor.
    """

    def __init__(self, spec: EnvSpec, reset_fn: Callable, step_fn: Callable,
                 obs_fn: Callable, mega: Optional[MegaConsts] = None,
                 megakernel: bool = False):
        self.spec = spec
        self.mega = mega
        self.megakernel = bool(megakernel)
        if self.megakernel and mega is None:
            raise ValueError("megakernel=True needs MegaConsts (mega=...); "
                             "suite.make_env builds them")
        self._reset_fn = reset_fn
        self._step_fn = step_fn
        self._obs_fn = obs_fn

    @property
    def device(self) -> torch.device:
        return self.mega.sensor.device

    def with_megakernel(self, flag: bool = True) -> "VectorEnv":
        """The same env family on the other step path (shared fns)."""
        return VectorEnv(self.spec, self._reset_fn, self._step_fn,
                         self._obs_fn, mega=self.mega, megakernel=flag)

    def reset(self, gen: torch.Generator, num_envs: int):
        seeds = derive_seeds(gen, num_envs)
        state = self._reset_fn(seeds, torch.zeros_like(seeds))
        return state, self._obs_fn(state)

    def step(self, state: EnvState, action):
        """-> (state, obs, reward, done) with ``done`` boolean."""
        if self.megakernel:
            from repro_torch.kernels import ops
            mc = self.mega
            out = ops.env_mega_step(
                *state, action, None, None, 0, 0, mc.sensor, mc.tgt,
                mc.masses, mc.lengths, chain=mc.chain, task=mc.task,
                substeps=self.spec.substeps, dt=self.spec.dt,
                max_episode_len=self.spec.max_episode_len)
            q, qd, root, pa, t, seed, resets, obs, reward, done = out[:10]
            return (EnvState(q, qd, root, pa, t, seed, resets), obs,
                    reward, done > 0)
        new_state, reward, done = self._step_fn(state, action)
        # materialized auto-reset: the fresh state is a pure function of
        # (seed, resets+1), computed unconditionally and selected
        fresh = self._reset_fn(new_state.seed, new_state.resets + 1)
        out = EnvState(*[
            torch.where(done.view((-1,) + (1,) * (a.dim() - 1)), b, a)
            for a, b in zip(new_state, fresh)])
        return out, self._obs_fn(out), reward, done
