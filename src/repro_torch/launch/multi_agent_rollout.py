"""Multi-agent shared-world rollouts on the num_env ladder (runnable
counterpart of ``examples/multi_agent_rollout.py``).

K agents drive one articulated chain world (``envs/multi_agent.py``):
agent k owns joint block [k*J, (k+1)*J), the chain coupling links
neighbouring agents' boundary joints, and the world's done resets all K
agents together.  Per-agent obs and action dims match the single-agent
family, so the same policy serves any K.

    PYTHONPATH=src python -m repro_torch.launch.multi_agent_rollout \\
        --device cuda
    PYTHONPATH=src python -m repro_torch.launch.multi_agent_rollout \\
        --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.envs import make_env, make_multi_agent_env
from repro_torch.models.policy import init_policy
from repro_torch.rl.rollout import collect
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    K = 4
    env = make_multi_agent_env("Ant", num_agents=K, device=device)
    num_envs = 32                       # 8 worlds x 4 agents
    T = 8
    params = init_policy(torch.Generator(device).manual_seed(0),
                         env.spec.policy_dims)

    state, obs = env.reset(torch.Generator(device).manual_seed(0), num_envs)
    traj, state, obs, last_value = collect(
        params, env, state, obs, torch.Generator(device).manual_seed(1), T)
    print(f"{K}-agent Ant: obs {tuple(traj.obs.shape)} actions "
          f"{tuple(traj.actions.shape)} rewards {tuple(traj.rewards.shape)}")
    print(f"mean reward/agent: {float(traj.rewards.mean()):+.3f}")

    # world-shared done: all K agents of a world terminate together
    d = traj.dones.reshape(T, num_envs // K, K)
    assert bool(torch.all(d == d[:, :, :1])), "agents of a world share done"

    # the same policy serves the single-agent family: one ladder, K x the
    # rungs
    env1 = make_env("Ant", device=device)
    s1, o1 = env1.reset(torch.Generator(device).manual_seed(0), 8)
    t1, *_ = collect(params, env1, s1, o1,
                     torch.Generator(device).manual_seed(1), T)
    print(f"same policy on single-agent Ant: obs {tuple(t1.obs.shape)}")
    return traj, t1


if __name__ == "__main__":
    main()
