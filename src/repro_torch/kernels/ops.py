"""Public wrappers for the port's kernels.

Each wrapper dispatches on the device of the tensors it is given, not on a
backend probe: tensors on the CPU take the plain PyTorch version in
``ref.py``; any other tensor must be on a CUDA device, and there the wrapper
checks dtype, shape and contiguity, launches the hand-written kernel on the
current stream, and raises if the launch fails.  Nothing falls back.

``LAUNCHES`` counts kernel launches per wrapper (plain integers; a CPU call
counts nothing), so a run can show that its main path went through the
kernels.  ``reset_launches()`` sets every count to 0.

The two kernels a training forward runs, ``flash_attention`` and
``mlstm_chunkwise``, write their outputs through ctypes, which autograd
cannot see.  Their CUDA launch runs inside a ``torch.autograd.Function``:
the forward is the hand-written kernel, and the backward recomputes the
plain math from the saved inputs and differentiates it with autograd,
which is how the reference trains (it has no backward kernel).  Where no
input requires grad, ``apply`` builds no graph and only the kernel runs.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref

LAUNCHES = {"env_mega_step": 0, "gae_norm": 0, "policy_mlp": 0,
            "nstep_returns": 0, "pack_channels": 0, "paged_attention": 0,
            "flash_attention": 0, "mlstm_chunkwise": 0}


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


def nstep_returns(rewards, dones, bootstrap, *, gamma=0.99):
    """A3C n-step discounted returns: the reverse scan
    ``G_t = r_t + gamma * G_{t+1} * (1 - d_t)`` from ``bootstrap``.
    rewards/dones: (T, N); bootstrap: (N,).  Returns (T, N) float32."""
    if _on_cpu(rewards, "nstep_returns"):
        return ref.nstep_returns_ref(rewards, dones, bootstrap, gamma)
    from repro_torch.kernels import gae_scan
    out = gae_scan.launch_nstep(rewards, dones, bootstrap, gamma=gamma)
    LAUNCHES["nstep_returns"] += 1
    return out


def pack_channels(bufs, payloads, slot: int):
    """Write one push into ring slot ``slot`` in place (all six channels
    in one launch; the ``channel_pack`` layout).  ``bufs``/``payloads`` are
    keyed by ``channel_pack.CHANNELS``; ``slot`` is a Python int.  Returns
    ``bufs``."""
    if _on_cpu(bufs["rewards"], "pack_channels"):
        return ref.pack_channels_ref(bufs, payloads, slot)
    from repro_torch.kernels import channel_pack
    out = channel_pack.launch(bufs, payloads, slot)
    LAUNCHES["pack_channels"] += 1
    return out


def paged_attention(q, k_pages, v_pages, slot_pos, table, positions, *,
                    window=None, softcap=None, scale=None):
    """Paged gather-decode attention: one decode token per row read through
    a per-row page table.  q: (B, H, hd); k/v pages: (N, page, KH, hd);
    slot_pos: (N, page) int32; table: (B, M) int32 (-1 unmapped);
    positions: (B,) int32 (negative = idle row, output 0).  ``window`` is
    a Python int or None.  Returns (B, H, hd) in q's dtype."""
    if _on_cpu(q, "paged_attention"):
        return ref.paged_attention_ref(q, k_pages, v_pages, slot_pos, table,
                                       positions, window=window,
                                       softcap=softcap, scale=scale)
    from repro_torch.kernels import paged_decode
    out = paged_decode.launch(q, k_pages, v_pages, slot_pos, table,
                              positions, window=window, softcap=softcap,
                              scale=scale)
    LAUNCHES["paged_attention"] += 1
    return out


def _grads(ctx, fn, inputs, outs_grads):
    """Autograd of ``fn(*inputs)`` against ``outs_grads`` (one per output,
    None where no gradient flows), for the inputs ``ctx`` says need one;
    None for the others."""
    need = ctx.needs_input_grad[:len(inputs)]
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, need)]
        outs = fn(*xs)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        pairs = [(o, g) for o, g in zip(outs, outs_grads) if g is not None]
        wrt = [x for x, n in zip(xs, need) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wrt, [g for _, g in pairs],
                                       allow_unused=True)) \
            if pairs and wrt else iter(())
    return tuple(next(got, None) if n else None for n in need)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel forward; ``plain``'s gradient backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, plain):
        from repro_torch.kernels import flash_attention as fa
        out = fa.launch(q, k, v, causal=causal, window=window,
                        softcap=softcap, scale=scale)
        LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v)
        ctx.plain = plain if plain is not None else functools.partial(
            ref.attention_ref, causal=causal, window=window,
            softcap=softcap, scale=scale)
        return out

    @staticmethod
    def backward(ctx, g):
        return _grads(ctx, ctx.plain, ctx.saved_tensors, (g,)) + (None,) * 5


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, plain=None):
    """Blocked online-softmax attention with GQA and an index-based causal
    / sliding-window mask (query i and key j at positions i and j).
    q: (B, Sq, H, hd); k/v: (B, Skv, KH, hd).  Returns (B, Sq, H, hd).
    On the card its gradient is autograd of ``plain(q, k, v)``, the plain
    route the caller attends by (``ref.attention_ref`` when None)."""
    if _on_cpu(q, "flash_attention"):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                 plain)


class _MLSTMChunkwise(torch.autograd.Function):
    """The mLSTM kernel forward; ``ref.mlstm_chunkwise_ref``'s gradient
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f, C0, n0, m0, chunk):
        from repro_torch.kernels import mlstm_scan
        out = mlstm_scan.launch(q, k, v, log_i, log_f, C0, n0, m0,
                                chunk=chunk)
        LAUNCHES["mlstm_chunkwise"] += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, log_i, log_f, C0, n0, m0)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, *gs):
        return _grads(ctx, lambda *x: ref.mlstm_chunkwise_ref(*x, ctx.chunk),
                      ctx.saved_tensors, gs) + (None,)


def mlstm_chunkwise(q, k, v, log_i, log_f, C0, n0, m0, *, chunk: int):
    """Chunkwise mLSTM from the state (C0, n0, m0): log-gated masked linear
    attention inside chunks of ``L = min(chunk, S)`` steps (L must divide
    S) and the state carried across them.  q/k/v: (B, H, S, dh);
    log_i/log_f: (B, H, S); C0: (B, H, dh, dh) storing v (x) k; n0:
    (B, H, dh); m0: (B, H); all f32.  Returns (h (B, H, S, dh), C, n, m).
    On the card its gradient is the plain version's."""
    args = (q, k, v, log_i, log_f, C0, n0, m0)
    if _on_cpu(q, "mlstm_chunkwise"):
        return ref.mlstm_chunkwise_ref(*args, chunk)
    return _MLSTMChunkwise.apply(*args, chunk)
