"""DRL policy networks — the paper's Table 6 MLP policies (port of
``repro/models/policy.py``).

Parameters are a plain dict of tensors with weights laid out ``(in, out)``
as in the reference.  Each benchmark uses an MLP ``in:hidden...:act``
actor with a value head off the last hidden layer and a diagonal-Gaussian
action distribution.  :func:`policy_apply_fused` computes the same function
with the trunk on the fused kernel (``ops.policy_mlp``); the heads stay
``torch.matmul``, as the reference kernel computes only the trunk.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from repro_torch.utils import he_init


def init_policy(gen: torch.Generator, dims: Sequence[int]):
    """dims = [in, h1, ..., hk, act_dim] (paper Table 6 format); tensors
    are made on ``gen.device``."""
    dev = gen.device
    layers = []
    for i in range(len(dims) - 2):
        layers.append({"w": he_init(gen, (dims[i], dims[i + 1])),
                       "b": torch.zeros((dims[i + 1],), device=dev)})
    return {
        "trunk": layers,
        "mu": {"w": he_init(gen, (dims[-2], dims[-1])) * 0.01,
               "b": torch.zeros((dims[-1],), device=dev)},
        "log_std": torch.zeros((dims[-1],), device=dev),
        "value": {"w": he_init(gen, (dims[-2], 1)),
                  "b": torch.zeros((1,), device=dev)},
    }


def policy_trunk(params, obs):
    h = obs
    for lyr in params["trunk"]:
        h = torch.tanh(h @ lyr["w"] + lyr["b"])
    return h


def _heads(params, h):
    mu = h @ params["mu"]["w"] + params["mu"]["b"]
    value = (h @ params["value"]["w"] + params["value"]["b"])[..., 0]
    log_std = params["log_std"].expand(mu.shape)
    return mu, log_std, value


def policy_apply(params, obs) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """obs (..., in_dim) -> (mu, log_std, value)."""
    return _heads(params, policy_trunk(params, obs))


def policy_apply_fused(params, obs):
    """:func:`policy_apply` with the trunk in one fused kernel launch
    (acting only: the kernel has no backward)."""
    from repro_torch.kernels import ops
    trunk = params["trunk"]
    h = ops.policy_mlp(obs, [lyr["w"] for lyr in trunk],
                       [lyr["b"] for lyr in trunk])
    return _heads(params, h)


def sample_action(mu, log_std, noise):
    """``noise`` is a standard-normal tensor of ``mu``'s shape."""
    return mu + torch.exp(log_std) * noise


def log_prob(mu, log_std, action):
    var = torch.exp(2 * log_std)
    lp = -0.5 * (torch.square(action - mu) / var
                 + 2 * log_std + math.log(2 * math.pi))
    return torch.sum(lp, dim=-1)


def entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
