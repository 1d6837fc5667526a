"""Public wrappers for the port's kernels.

Each wrapper dispatches on the device of the tensors it is given, not on a
backend probe: tensors on the CPU take the plain PyTorch version in
``ref.py``; any other tensor must be on a CUDA device, and there the wrapper
checks dtype, shape and contiguity, launches the hand-written kernel on the
current stream, and raises if the launch fails.  Nothing falls back.

``LAUNCHES`` counts kernel launches per wrapper (plain integers; a CPU call
counts nothing), so a run can show that its main path went through the
kernels.  ``reset_launches()`` sets every count to 0.
"""
from __future__ import annotations

from repro_torch.kernels import ref

LAUNCHES = {"env_mega_step": 0, "gae_norm": 0, "policy_mlp": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(x, op: str) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{op}: tensors must be on the CPU or a CUDA "
                         f"device, got {x.device}")
    return False


def env_mega_step(q, qd, root, prev_action, t, seed, resets, action, obs,
                  bufs, step_t, slot, sensor, tgt, masses, lengths, *,
                  chain, task, substeps, dt, max_episode_len):
    """Fused env step: physics substeps + reward + bookkeeping + predicated
    counter-PRNG auto-reset + observation.  With ``bufs`` (the ``{obs,
    actions, rewards, dones}`` ring dict) it also writes the acted-on
    ``obs``, the raw ``action``, reward and done into ring row ``step_t``,
    columns ``[slot*N, (slot+1)*N)``, in place; ``bufs=None`` writes no
    ring.  Returns ``(q, qd, root, prev_action, t, seed, resets, obs,
    reward, done_f32, bufs)``."""
    args = (q, qd, root, prev_action, t, seed, resets, action, obs, bufs,
            step_t, slot, sensor, tgt, masses, lengths)
    kw = dict(chain=chain, task=task, substeps=substeps, dt=dt,
              max_episode_len=max_episode_len)
    if _on_cpu(q, "env_mega_step"):
        return ref.mega_step(*args, **kw)
    from repro_torch.kernels import env_megakernel
    out = env_megakernel.launch(*args, **kw)
    LAUNCHES["env_mega_step"] += 1
    return out


def gae_norm(rewards, values, dones, last_value, *, gamma=0.99, lam=0.95,
             eps=1e-8):
    """Fused GAE + global advantage normalization.  rewards/values/dones:
    (T, N); last_value: (N,).  Returns (normalized_advs, returns), both
    (T, N) float32."""
    if _on_cpu(rewards, "gae_norm"):
        return ref.gae_norm_ref(rewards, values, dones, last_value, gamma,
                                lam, eps)
    from repro_torch.kernels import gae_scan
    out = gae_scan.launch(rewards, values, dones, last_value, gamma=gamma,
                          lam=lam, eps=eps)
    LAUNCHES["gae_norm"] += 1
    return out


def policy_mlp(x, weights, biases):
    """Fused tanh-MLP trunk.  x: (N, d0); weights[i]: (d_i, d_{i+1});
    biases[i]: (d_{i+1},).  Returns (N, d_L)."""
    if _on_cpu(x, "policy_mlp"):
        return ref.policy_mlp_ref(x, weights, biases)
    from repro_torch.kernels import fused_policy_mlp
    out = fused_policy_mlp.launch(x, weights, biases)
    LAUNCHES["policy_mlp"] += 1
    return out
