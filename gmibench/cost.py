"""Operations and bytes of the work the benchmark's metrics divide by.

``policy_mlp`` and ``env_mega_step`` count one launch of the port's two
rollout kernels from its shapes (a frozen copy of the formulas the port
keeps in ``repro_torch/kernels/cost.py``): bytes count each input read
once and each output written once; operations count what the algorithm
needs, each multiply once.  ``ppo_iteration_flops`` counts the model
FLOPs of one synchronous PPO iteration over every GMI.
"""
from __future__ import annotations

from gmibench import peaks


def forward_flops(dims) -> int:
    """Model FLOPs of one sample's forward pass of the policy ``dims``
    (in:hidden...:act), the mean and value heads included: two per
    weight."""
    trunk = sum(a * b for a, b in zip(dims[:-2], dims[1:-1]))
    return 2 * (trunk + dims[-2] * dims[-1] + dims[-2])


def ppo_iteration_flops(cfg: dict, traffic: dict) -> int:
    """Model FLOPs of one PPO iteration over all GMIs: the rollout's
    forwards (``num_steps`` acting passes and the bootstrap value) and,
    for every sample of every epoch, a forward and a backward (3 x
    forward).  The env physics and the loss's elementwise work are not
    counted."""
    p = cfg["ppo"]
    envs = traffic["gmis"] * traffic["envs_per_gmi"]
    T = p["num_steps"]
    passes = (T + 1) + 3 * p["num_epochs"] * T
    return forward_flops(cfg["policy_dims"]) * envs * passes


def policy_mlp(dims, n):
    """(bytes, ops) of one fused trunk launch over ``n`` rows: the trunk
    ``dims`` (the policy's widths without the action width)."""
    pairs = list(zip(dims[:-1], dims[1:]))
    bytes_ = 4 * (n * dims[0] + sum(a * b + b for a, b in pairs)
                  + n * dims[-1])
    ops = sum(2 * n * a * b + 2 * n * b for a, b in pairs)
    return bytes_, ops


def env_mega_step(n, J, obs_dim, substeps):
    """(bytes, projection ops, other ops) of one env-step launch over
    ``n`` envs of ``J`` joints."""
    R = 6 + 4 * J + 3
    bytes_ = 4 * (3 * n * J + 6 * n + 3 * n + R * obs_dim + 3 * J) \
        + 4 * (3 * n * J + 6 * n + 2 * n + n * obs_dim + 2 * n)
    proj = 2 * n * R * obs_dim
    rest = n * obs_dim + n * substeps * (32 * J + 30)
    return bytes_, proj, rest


def policy_mlp_bound_s(dims, n) -> float:
    """The least time one trunk launch could take: its bytes at the HBM's
    rate or its operations at the TF32 peak, whichever is longer."""
    b, ops = policy_mlp(dims, n)
    return max(b / peaks.HBM_BYTES_PER_S, ops / peaks.TF32_DENSE)


def env_mega_step_bound_s(n, J, obs_dim, substeps) -> float:
    """The least time one env-step launch could take: its bytes at the
    HBM's rate, or its projection at the TF32 peak plus the rest at the
    float32 peak, whichever is longer."""
    b, proj, rest = env_mega_step(n, J, obs_dim, substeps)
    return max(b / peaks.HBM_BYTES_PER_S,
               proj / peaks.TF32_DENSE + rest / peaks.FP32)
