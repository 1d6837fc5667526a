"""Articulated-chain rigid-body dynamics core (port of
``repro/envs/physics.py``).

Every function takes an explicit leading batch dimension where the JAX
version is vmapped: ``q``/``qd`` are ``(..., J)`` and ``root`` is
``(..., 6)``.  Per substep (semi-implicit Euler):
  qdd_i = (tau_i - damping*qd_i - g*m_i*l_i*sin(q_i)
           + coupling*(q_{i-1} - 2 q_i + q_{i+1})) / I_i
with ground contact on the chain tip and root dynamics driven by the net
joint reaction.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ChainParams(NamedTuple):
    masses: torch.Tensor   # (J,)
    lengths: torch.Tensor  # (J,)
    damping: float
    coupling: float
    stiffness: float       # restoring spring toward q=0 (joint limits)
    max_qd: float
    gravity: float
    torque_scale: float
    ground_k: float        # contact spring
    ground_c: float        # contact damper


def default_params(num_joints: int, *, device="cpu", damping=0.5,
                   coupling=0.6, stiffness=2.0, max_qd=8.0, gravity=9.81,
                   torque_scale=3.0, ground_k=60.0,
                   ground_c=2.0) -> ChainParams:
    idx = torch.arange(num_joints, dtype=torch.float32, device=device)
    masses = 1.0 + 0.15 * torch.cos(idx)
    lengths = 0.35 + 0.05 * torch.sin(1.7 * idx)
    return ChainParams(masses, lengths, damping, coupling, stiffness, max_qd,
                       gravity, torque_scale, ground_k, ground_c)


def tip_height(q, root_z, params: ChainParams):
    """Height of the chain tip (forward kinematics along the chain)."""
    angles = torch.cumsum(q, dim=-1)
    return root_z + torch.sum(params.lengths * torch.cos(angles), dim=-1)


# --------------------------------------------------- counter-based PRNG ---
# Murmur3 fmix32 feeding Box-Muller, as in the reference.  PyTorch on the
# CPU has no uint32 ``>>`` or ``+``, so the words live in int64 masked to
# 32 bits; products are split into 16-bit halves so no int64 product can
# overflow.  The hash and the 24-bit uniforms match the reference bit for
# bit; the normals go through log/sqrt/cos and match to a few ulps.
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32)."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _u32(x):
    return torch.as_tensor(x).to(torch.int64) & _M32


def hash_u32(x):
    """Murmur3 fmix32 on int64 words holding uint32 values."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def counter_normal(seed, counter, idx):
    """Standard normals, one per (seed, counter, idx) triple; the three
    broadcast together.  Same contract as the reference."""
    s, c, i = _u32(seed), _u32(counter), _u32(idx)
    base = hash_u32(s ^ _mul32(c, 0x9E3779B9))
    h1 = hash_u32((base + i * 2 + 1) & _M32)
    h2 = hash_u32((base + i * 2 + 2) & _M32)
    # 24-bit mantissa uniforms; u1 offset into (0, 1] so log never sees 0
    u1 = (h1 >> 8).to(torch.float32) * (1.0 / 16777216.0) \
        + (0.5 / 16777216.0)
    u2 = (h2 >> 8).to(torch.float32) * (1.0 / 16777216.0)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos((2.0 * math.pi) * u2)


def substep(q, qd, root, tau, params: ChainParams, dt: float):
    # neighbor coupling (tridiagonal spring network), edge-padded
    q_pad = torch.cat([q[..., :1], q, q[..., -1:]], dim=-1)
    lap = q_pad[..., :-2] - 2.0 * q + q_pad[..., 2:]
    inertia = params.masses * torch.square(params.lengths) + 1e-3
    grav = params.gravity * params.masses * params.lengths * torch.sin(q)
    qdd = (params.torque_scale * tau - params.damping * qd
           - params.stiffness * q - grav + params.coupling * lap) / inertia
    qd = torch.clamp(qd + dt * qdd, -params.max_qd, params.max_qd)
    q = q + dt * qd

    # root: driven by mean joint reaction, with ground contact at tip
    tip_h = tip_height(q, root[..., 2], params)
    pen = torch.clamp(-tip_h, min=0.0)
    contact_f = params.ground_k * pen - params.ground_c * torch.clamp(
        root[..., 5], max=0.0) * (pen > 0)
    thrust = torch.stack([
        torch.mean(torch.sin(q) * tau, dim=-1) * params.torque_scale,
        0.1 * torch.mean(torch.cos(2 * q) * tau, dim=-1),
        contact_f - params.gravity * 0.5,
    ], dim=-1)
    vel = root[..., 3:] + dt * thrust
    vel = vel * (1.0 - 0.02)                                # air drag
    pos = root[..., :3] + dt * vel
    pos = torch.cat([pos[..., :2], torch.clamp(pos[..., 2:3], min=0.05)],
                    dim=-1)
    return q, qd, torch.cat([pos, vel], dim=-1)


def rollout_substeps(q, qd, root, tau, params: ChainParams, dt: float,
                     substeps: int):
    for _ in range(substeps):
        q, qd, root = substep(q, qd, root, tau, params, dt / substeps)
    return q, qd, root
