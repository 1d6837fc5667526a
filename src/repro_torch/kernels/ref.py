"""Plain PyTorch versions of the port's kernels (the allclose targets).

Names follow ``repro/kernels/ref.py``.  ``ops`` calls these for tensors on
the CPU; the tests hold them against the JAX package, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.envs.physics import (ChainParams, counter_normal,
                                      rollout_substeps, tip_height)


def policy_mlp_ref(x, weights, biases):
    """x: (N, in); tanh MLP trunk: h = tanh(h @ w + b) per layer."""
    h = x.float()
    for w, b in zip(weights, biases):
        h = torch.tanh(h @ w.float() + b.float())
    return h.to(x.dtype)


def gae_norm_ref(rewards, values, dones, last_value, gamma: float = 0.99,
                 lam: float = 0.95, eps: float = 1e-8):
    """Reverse GAE scan + global advantage normalization (population std,
    two-pass centred variance).  rewards/values/dones: (T, N);
    last_value: (N,).  Returns (normalized_advs, returns), (T, N) f32."""
    r, v, d = rewards.float(), values.float(), dones.float()
    adv = torch.zeros_like(last_value, dtype=torch.float32)
    v_next = last_value.float()
    advs = []
    for t in reversed(range(r.shape[0])):
        nonterm = 1.0 - d[t]
        delta = r[t] + gamma * v_next * nonterm - v[t]
        adv = delta + gamma * lam * nonterm * adv
        advs.append(adv)
        v_next = v[t]
    advs = torch.stack(advs[::-1])
    returns = advs + v
    advs = (advs - advs.mean()) / (advs.std(correction=0) + eps)
    return advs, returns


def nstep_returns_ref(rewards, dones, bootstrap, gamma: float = 0.99):
    """Reverse discounted scan ``G_t = r_t + gamma * G_{t+1} * (1 - d_t)``
    bootstrapped from the last value.  rewards/dones: (T, N); bootstrap:
    (N,).  Returns (T, N) float32."""
    r, d = rewards.float(), dones.float()
    g = bootstrap.float()
    rets = []
    for t in reversed(range(r.shape[0])):
        g = r[t] + gamma * g * (1.0 - d[t])
        rets.append(g)
    return torch.stack(rets[::-1])


def pack_channels_ref(bufs, payloads, slot: int):
    """Ring pack of one push, in place, in the ``channel_pack`` layout:
    (T, N, ...) channels into columns ``[slot*N, (slot+1)*N)``, bootstrap
    and actor_version into row ``slot``.  Other slots survive.  Returns
    ``bufs``."""
    N = payloads["rewards"].shape[1]
    col = slot * N
    for c in ("obs", "actions", "rewards", "dones"):
        bufs[c][:, col:col + N] = payloads[c]
    bufs["bootstrap"][slot] = payloads["bootstrap"].reshape(N)
    v = payloads["actor_version"]
    bufs["actor_version"][slot] = v.reshape(1) if isinstance(
        v, torch.Tensor) else v
    return bufs


def write_ring(bufs, obs, action, reward, done_f, step_t: int, slot: int):
    """In-place ring-row write in the ``channel_pack`` slot layout: row
    ``step_t``, columns ``[slot*N, (slot+1)*N)``.  Other cells survive."""
    N = action.shape[0]
    col = slot * N
    bufs["obs"][step_t, col:col + N] = obs
    bufs["actions"][step_t, col:col + N] = action
    bufs["rewards"][step_t, col:col + N] = reward
    bufs["dones"][step_t, col:col + N] = done_f
    return bufs


def env_mega_step_ref(q, qd, root, prev_action, t, seed, resets, action,
                      obs, bufs, step_t, slot, sensor, tgt, masses,
                      lengths, *, chain, task, substeps, dt,
                      max_episode_len):
    """Env-megakernel oracle: ``physics.rollout_substeps`` + suite reward
    and bookkeeping with a MATERIALIZED counter-based auto-reset, plus the
    ring writes (in place into ``bufs`` when it is not None).  Returns
    ``(q, qd, root, prev_action, t, seed, resets, obs, reward, done_f32,
    bufs)``."""
    params = ChainParams(masses, lengths, *chain)
    w_fwd, w_up, w_ctrl, w_tgt, fall_z = task
    J = q.shape[1]
    a = torch.clamp(action, -1.0, 1.0)
    q, qd, root = rollout_substeps(q, qd, root, a, params, dt, substeps)
    reward = (w_fwd * root[:, 3]
              + w_up * torch.cos(torch.mean(q, dim=1))
              - w_ctrl * torch.sum(torch.square(a), dim=1)
              - w_tgt * torch.mean(torch.square(q - tgt), dim=1)
              + 0.5)
    t = t + 1
    done = (t >= max_episode_len) | (root[:, 2] < fall_z)
    idx = torch.arange(J, dtype=torch.int64, device=q.device)
    fresh_q = 0.1 * counter_normal(seed[:, None], (resets + 1)[:, None], idx)
    root0 = torch.tensor([0., 0., 0.6, 0., 0., 0.], device=q.device)
    d = done[:, None]
    q = torch.where(d, fresh_q, q)
    qd = torch.where(d, 0.0, qd)
    root = torch.where(d, root0, root)
    pa = torch.where(d, 0.0, a)
    t = torch.where(done, 0, t).to(torch.int32)
    resets = torch.where(done, resets + 1, resets).to(torch.int32)
    tip = tip_height(q, root[:, 2], params)
    raw = torch.cat([root, torch.sin(q), torch.cos(q), qd, pa,
                     torch.stack([tip, root[:, 2] - 0.6,
                                  torch.mean(torch.abs(qd), dim=1)], dim=1)],
                    dim=1)
    done_f = done.float()
    if bufs is not None:
        write_ring(bufs, obs, action, reward, done_f, step_t, slot)
    return (q, qd, root, pa, t, seed, resets, torch.tanh(raw @ sensor),
            reward, done_f, bufs)


def mega_step(q, qd, root, prev_action, t, seed, resets, action, obs, bufs,
              step_t, slot, sensor, tgt, masses, lengths, *, chain, task,
              substeps, dt, max_episode_len):
    """The fused batched env step, op for op the reference's
    ``env_megakernel._step_core`` (neighbor coupling via shifts, the reset
    selected by the done predicate), plus the optional ring writes.  The
    plain version ``ops.env_mega_step`` runs on CPU tensors; same return
    tuple as :func:`env_mega_step_ref`."""
    (damping, coupling, stiffness, max_qd, gravity, torque_scale,
     ground_k, ground_c) = chain
    w_fwd, w_up, w_ctrl, w_tgt, fall_z = task
    a = torch.clamp(action, -1.0, 1.0)
    inertia = masses * torch.square(lengths) + 1e-3
    h = dt / substeps
    for _ in range(substeps):
        left = torch.cat([q[:, :1], q[:, :-1]], dim=1)
        right = torch.cat([q[:, 1:], q[:, -1:]], dim=1)
        lap = left - 2.0 * q + right
        grav = gravity * masses * lengths * torch.sin(q)
        qdd = (torque_scale * a - damping * qd - stiffness * q - grav
               + coupling * lap) / inertia
        qd = torch.clamp(qd + h * qdd, -max_qd, max_qd)
        q = q + h * qd
        tip_h = root[:, 2] + torch.sum(
            lengths * torch.cos(torch.cumsum(q, dim=1)), dim=1)
        pen = torch.clamp(-tip_h, min=0.0)
        contact_f = ground_k * pen - ground_c * torch.clamp(
            root[:, 5], max=0.0) * (pen > 0)
        thrust = torch.stack([
            torch.mean(torch.sin(q) * a, dim=1) * torque_scale,
            0.1 * torch.mean(torch.cos(2 * q) * a, dim=1),
            contact_f - gravity * 0.5,
        ], dim=1)
        vel = (root[:, 3:] + h * thrust) * (1.0 - 0.02)
        pos = root[:, :3] + h * vel
        pos = torch.cat([pos[:, :2], torch.clamp(pos[:, 2:3], min=0.05)],
                        dim=1)
        root = torch.cat([pos, vel], dim=1)
    reward = (w_fwd * root[:, 3]
              + w_up * torch.cos(torch.mean(q, dim=1))
              - w_ctrl * torch.sum(torch.square(a), dim=1)
              - w_tgt * torch.mean(torch.square(q - tgt), dim=1)
              + 0.5)
    t = t + 1
    done = (t >= max_episode_len) | (root[:, 2] < fall_z)
    idx = torch.arange(q.shape[1], dtype=torch.int64, device=q.device)
    d = done[:, None]
    fresh_q = 0.1 * counter_normal(seed[:, None], (resets + 1)[:, None], idx)
    cidx = torch.arange(6, device=q.device)
    root0 = torch.where(cidx == 2, 0.6, 0.0).to(root.dtype)
    q = torch.where(d, fresh_q, q)
    qd = torch.where(d, 0.0, qd)
    root = torch.where(d, root0, root)
    pa = torch.where(d, 0.0, a)
    t = torch.where(done, 0, t).to(torch.int32)
    resets = torch.where(done, resets + 1, resets).to(torch.int32)
    tip_h = root[:, 2] + torch.sum(
        lengths * torch.cos(torch.cumsum(q, dim=1)), dim=1)
    raw = torch.cat([root, torch.sin(q), torch.cos(q), qd, pa,
                     torch.stack([tip_h, root[:, 2] - 0.6,
                                  torch.mean(torch.abs(qd), dim=1)], dim=1)],
                    dim=1)
    done_f = done.float()
    if bufs is not None:
        write_ring(bufs, obs, action, reward, done_f, step_t, slot)
    return (q, qd, root, pa, t, seed, resets, torch.tanh(raw @ sensor),
            reward, done_f, bufs)


NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None):
    """Index-masked attention, the plain version of the flash kernel.
    q: (B, Sq, H, hd); k/v: (B, Skv, KH, hd) with H % KH == 0; query i and
    key j sit at positions i and j.  Computes in f32, returns q's dtype."""
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else hd ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, KH, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, slot_pos, table, positions, *,
                        window=None, softcap=None, scale=None):
    """Gather-decode attention, the plain version of the paged kernel.

    q: (B, H, hd) one decode token per row; k/v pages: (N, page, KH, hd);
    slot_pos: (N, page) absolute positions (-1 empty); table: (B, M)
    physical page ids (-1 unmapped -> masked); positions: (B,) absolute q
    position per row.  Gathers each row's pages into position order and
    runs masked softmax attention in f32; invalid v rows are zeroed, so a
    row whose keys are all masked gives exactly 0."""
    B, H, hd = q.shape
    N, page, KH, _ = k_pages.shape
    M = table.shape[1]
    G = H // KH
    scale = scale if scale is not None else hd ** -0.5
    tsafe = torch.clamp(table, min=0).long()
    k = k_pages[tsafe].reshape(B, M * page, KH, hd).float()
    v = v_pages[tsafe].reshape(B, M * page, KH, hd).float()
    kpos = torch.where(torch.repeat_interleave(table >= 0, page, dim=1),
                       slot_pos[tsafe].reshape(B, M * page), -1)
    qf = (q.float() * scale).reshape(B, KH, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qpos = positions[:, None]
    valid = (kpos >= 0) & (kpos <= qpos)
    if window is not None:
        valid &= kpos > qpos - window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p,
                     torch.where(valid[:, :, None, None], v, 0.0))
    return o.reshape(B, H, hd).to(q.dtype)


def mlstm_chunkwise_ref(q, k, v, log_i, log_f, C0, n0, m0, chunk: int):
    """Chunkwise-parallel stabilized mLSTM from a given state, the plain
    version of the mLSTM kernel.  q/k: (B, H, S, dk); v: (B, H, S, dv),
    dv <= dk; log_i/log_f: (B, H, S); C0 (B, H, dv, dk) storing v (x) k,
    n0 (B, H, dk), m0 (B, H), all f32.  Runs ``models.ssm._mlstm_chunk``
    over chunks of ``L = min(chunk, S)`` steps, which must divide S.
    Returns (h (B, H, S, dv), C, n, m)."""
    from repro_torch.models.ssm import _mlstm_chunk
    S = q.shape[2]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    C, n, m = C0, n0, m0
    outs = []
    for c in range(S // L):
        sl = slice(c * L, (c + 1) * L)
        h, C, n, m = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                  log_i[:, :, sl], log_f[:, :, sl], C, n, m)
        outs.append(h)
    return torch.cat(outs, dim=2), C, n, m
