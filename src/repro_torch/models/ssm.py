"""Recurrent blocks: mLSTM and sLSTM (xLSTM, arXiv:2405.04517), ported from
``repro/models/ssm.py``.

The mLSTM's chunkwise-parallel form ("masked linear attention inside a
chunk + recurrent (C, n, m) state across chunks") runs as ONE
``ops.mlstm_chunkwise`` call a block from the block's state: on a CUDA
tensor the hand-written kernel (``csrc/mlstm_chunkwise.cu``), on a CPU
tensor its plain version, which is :func:`_mlstm_chunk` over chunks.  The
reference runs the same chunk math in a ``lax.scan``.  Decode uses the
exact recurrent update, in plain ops as in the reference.  The sLSTM is
inherently sequential: the reference's ``lax.scan`` over time becomes a
Python loop of plain ops (the reference has no sLSTM kernel).

Each block has one body, which runs on the share of the block its
weights hold: all of it on one card, or in a sharded step's local region
(``spmd.Region``) the rank's share over ``model``, its weights cut to it
as :func:`mlstm_cuts`, :func:`slstm_cuts` and :func:`mamba2_cuts` say:
the mLSTM on its value rows, the sLSTM with its projections split,
Mamba2 on its heads or, with a state, on its head dim.  Without a region
the ``spmd.region_*`` meetings over ``model`` pass their tensors
unchanged.

Mamba2 (SSD, zamba2's backbone) runs its chunked scan with a carried
``(h, conv)`` state as a Python loop over chunks of plain batched matrix
products, as the reference's ``lax.scan`` of einsums (the reference has no
Pallas kernel for it), and decodes with the exact recurrent update.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm
from repro_torch.utils import lecun_init

LOG_EPS = -1e30


# ---------------------------------------------------------------- conv -----
def init_conv1d(gen: torch.Generator, channels: int, width: int):
    return {"w": lecun_init(gen, (width, channels), fan_in=width),
            "b": torch.zeros((channels,), dtype=torch.float32,
                             device=gen.device)}


def causal_conv1d(params, x, state=None):
    """Depthwise causal conv.  x: (B,S,C).  state: (B,W-1,C) prior inputs.
    Returns (silu(y), new_state), new_state holding the last W-1 inputs."""
    W = params["w"].shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    # depthwise: y[t] = sum_j w[j] * xp[t+j], summed in the reference's order
    y = sum(xp[:, j:j + x.shape[1]] * params["w"][j].to(x.dtype)
            for j in range(W))
    y = y + params["b"].to(x.dtype)
    new_state = xp[:, -(W - 1):] if W > 1 else state
    return F.silu(y), new_state


# ================================================================= mLSTM ===
class MLSTMState(NamedTuple):
    C: torch.Tensor      # (B,H,dh,dh) matrix memory, stores v (x) k
    #                      (a rank's value rows, (B,H,dv,dh), when split)
    n: torch.Tensor      # (B,H,dh)
    m: torch.Tensor      # (B,H) log-space stabilizer
    conv: torch.Tensor   # (B,W-1,Di) conv state


def init_mlstm(gen: torch.Generator, d_model: int, num_heads: int,
               expansion: int = 2, conv_width: int = 4):
    di = d_model * expansion
    dev = gen.device
    return {
        "norm": {"scale": torch.ones((d_model,), device=dev)},
        "w_up": lecun_init(gen, (d_model, 2 * di)),         # x path + z gate
        "conv": init_conv1d(gen, di, conv_width),
        "wq": lecun_init(gen, (di, di)),
        "wk": lecun_init(gen, (di, di)),
        "wv": lecun_init(gen, (di, di)),
        "w_if": lecun_init(gen, (di, 2 * num_heads)),       # i,f preacts
        "b_if": torch.zeros((2 * num_heads,), device=dev),
        "gnorm": {"scale": torch.ones((di,), device=dev)},
        "w_down": lecun_init(gen, (di, d_model)),
    }


def mlstm_init_state(batch: int, num_heads: int, dh: int, di: int,
                     conv_width: int = 4, dtype=torch.float32,
                     device="cpu", dv: int = None) -> MLSTMState:
    """A zero state; ``C`` holds ``dv`` value rows (all ``dh`` if None)."""
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        C=torch.zeros((batch, num_heads, dv or dh, dh), **f32),
        n=torch.zeros((batch, num_heads, dh), **f32),
        m=torch.zeros((batch, num_heads), **f32),     # 0, not -inf
        conv=torch.zeros((batch, conv_width - 1, di), dtype=dtype,
                         device=device))


def _mlstm_chunk(q, k, v, log_i, log_f, state_C, state_n, state_m):
    """One chunk of the stabilized chunkwise mLSTM.

    q,k: (B,H,L,dk); v: (B,H,L,dv) (any dv: each value row is
    independent); log_i/log_f: (B,H,L); C (B,H,dv,dk).  The scale is
    dk^-1/2.  Returns (h (B,H,L,dv), C', n', m')."""
    L, dh = q.shape[-2:]
    b = torch.cumsum(log_f, dim=-1)                          # inclusive
    # intra-chunk log weights: D[t,s] = b_t - b_s + log_i_s  (s <= t)
    lw = b[..., :, None] - b[..., None, :] + log_i[..., None, :]
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    lw = torch.where(causal, lw, LOG_EPS)
    # inter-chunk log weight for reading the carried state
    inter = state_m[..., None] + b                           # (B,H,L)
    m_t = torch.maximum(inter, torch.amax(lw, dim=-1))
    w_intra = torch.exp(lw - m_t[..., None])                 # (B,H,L,L)
    w_inter = torch.exp(inter - m_t)
    scale = dh ** -0.5
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) * scale * w_intra
    # C stores v (x) k (C[d,e] = v_d k_e); reading contracts q with e
    h_num = torch.einsum("bhts,bhsd->bhtd", scores, v) \
        + w_inter[..., None] * torch.einsum("bhte,bhde->bhtd", q * scale,
                                            state_C)
    n_t = torch.einsum("bhts,bhsd->bhtd", w_intra, k) \
        + w_inter[..., None] * state_n[..., None, :]
    denom = torch.maximum(
        torch.abs(torch.einsum("bhtd,bhtd->bht", q * scale, n_t)),
        torch.exp(-m_t))
    h = h_num / denom[..., None]
    # carry state to chunk end (position L-1, inclusive decay b[...,-1])
    bl = b[..., -1]                                          # (B,H)
    m_new = torch.maximum(state_m + bl,
                          torch.amax(log_i + (bl[..., None] - b), dim=-1))
    w_c = torch.exp(log_i + bl[..., None] - b - m_new[..., None])
    decay = torch.exp(state_m + bl - m_new)
    C_new = decay[..., None, None] * state_C + \
        torch.einsum("bhs,bhsd,bhse->bhde", w_c, v, k)
    n_new = decay[..., None] * state_n + torch.einsum("bhs,bhsd->bhd", w_c, k)
    return h, C_new, n_new, m_new


def mlstm_apply(params, x, *, num_heads: int, state: MLSTMState = None,
                chunk: int = 256, expansion: int = 2, region=None):
    """mLSTM block.  x: (B,S,D) -> (out, new_state).  The chunk scan is
    one ``ops.mlstm_chunkwise`` call from ``state`` (zero if None) over
    chunks of ``min(chunk, S)`` steps, which must divide S.  Inside a
    sharded step's local region ``region`` the block runs on the rank's
    value rows, ``params`` cut to them (:func:`_mlstm`)."""
    return _mlstm(params, x, num_heads, state, chunk, expansion, region)


def _mlstm_gates(params, x_c, num_heads: int):
    """(log_i, log_f), each (B, H, S) f32, of the convolved ``x_c``."""
    B, S, _ = x_c.shape
    dt = x_c.dtype
    if_pre = (x_c @ params["w_if"].to(dt)) + params["b_if"].to(dt)
    if_pre = if_pre.reshape(B, S, 2, num_heads).permute(0, 3, 1, 2).float()
    return (if_pre[..., 0].contiguous(),
            F.logsigmoid(if_pre[..., 1]).contiguous())


def _mlstm_step(q, k, v, log_i, log_f, state: MLSTMState):
    """The exact recurrent update of one step from ``state``: q (already
    scaled by dk^-1/2) and k (B, H, dk), v (B, H, dv), the gates (B, H),
    C (B, H, dv, dk).  Returns (h (B, H, dv), C', n', m')."""
    m_new = torch.maximum(log_f + state.m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + state.m - m_new)
    C = f_s[..., None, None] * state.C + i_s[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", v, k)
    n = f_s[..., None] * state.n + i_s[..., None] * k
    num = torch.einsum("bhe,bhde->bhd", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                        torch.exp(-m_new))
    return num / den[..., None], C, n, m_new


def mlstm_decode_step(params, x, state: MLSTMState, *, num_heads: int,
                      expansion: int = 2, region=None):
    """Exact recurrent single step.  x: (B,1,D).  With ``region``, on the
    rank's value rows (:func:`_mlstm`)."""
    return _mlstm(params, x, num_heads, state, 1, expansion, region,
                  decode=True)


def _heads_whole(region, num_heads: int, *ts):
    """Each (B, S, num_heads x part) ``t`` of the local region ``region``
    made whole over ``model``, every head's part gathered in rank order,
    in one gather for all; without a region, as they are."""
    from repro_torch.dist import spmd
    if region is None:
        return ts
    B, S, _ = ts[0].shape
    both = spmd.region_gather(torch.stack(ts, 2).reshape(
        B, S, len(ts), num_heads, -1), region, 4)
    return tuple(t.reshape(B, S, -1) for t in both.unbind(2))


def _rows(t, groups: int, lo: int, hi: int):
    """Entries ``lo .. hi`` of each of ``groups`` equal blocks of ``t``'s
    last dim."""
    return t.unflatten(-1, (groups, -1))[..., lo:hi].flatten(-2)


def _grid(H: int, P: int, hs, ps) -> np.ndarray:
    """The channels ``h P + p`` of a head-major (H, P) grid, ``h`` in
    ``hs`` and ``p`` in ``ps``, in order."""
    return np.arange(H * P).reshape(H, P)[hs, ps].reshape(-1)


@functools.lru_cache(maxsize=None)
def mlstm_cuts(m: int, num_heads: int, di: int) -> dict:
    """The ``spmd.Cut`` of each weight of an mLSTM block (``norm`` aside)
    for ``m`` ``model`` ranks: rank ``r`` computes with rows ``r dv ..
    (r + 1) dv`` of every head's value dim, ``dv = dk / m``, the split
    ``partition.cache_specs`` gives ``C``: those channels of the x path
    and z (``w_up``), the conv, ``wq``, ``wk``, ``wv`` and the gated
    norm, those rows of ``w_down``; the gates whole."""
    from repro_torch.dist.spmd import Cut
    dk = di // num_heads
    dv = dk // m
    ix = np.stack([_grid(num_heads, dk, slice(None),
                         slice(r * dv, (r + 1) * dv)) for r in range(m)])
    return {"w_up": Cut(1, np.concatenate([ix, di + ix], 1)),
            "conv": {"w": Cut(1, ix), "b": Cut(0, ix)},
            "wq": Cut(1, ix), "wk": Cut(1, ix), "wv": Cut(1, ix),
            "w_if": None, "b_if": None,
            "gnorm": {"scale": Cut(0, ix)}, "w_down": Cut(0, ix)}


def _mlstm(params, x, num_heads: int, state, chunk: int, expansion: int,
           region, decode: bool = False):
    """The mLSTM block (``decode``: its exact recurrent step) on the value
    rows ``params`` hold: all of them, or in the local region ``region``
    the rank's ``dv`` rows of every head (:func:`mlstm_cuts`), the split
    of ``C`` (B, H, dv, dk) that ``state`` then holds.  Each value row
    contracts with all of dk, so q and k are whole: the x path and z of
    ``w_up``, the conv and ``wq``/``wk`` run on the rank's channels, and
    one gather over ``model`` of (x, conv(x)) and one of (q, k) make them
    whole as activations.  v, C's rows, h and z are the rank's; n, m, the
    gates and the conv state are whole and the same on every rank; the
    scale is the whole head's ``dk^-1/2``.  The gated norm takes one sum
    over ``model`` of a value a row, and ``w_down``'s output is summed
    over ``model``.  Gradients: the input's is summed over ``model`` where
    it enters ``w_up``, and each gather's is summed and cut back
    (``spmd.region_gather``), so every weight's is this rank's share but
    the input norm's."""
    from repro_torch.dist import spmd
    B, S, D = x.shape
    H = num_heads
    di = D * expansion
    dk = di // H
    dv = params["wv"].shape[1] // H
    r = 0 if region is None else region.rank
    W = params["conv"]["w"].shape[0]
    dt = x.dtype
    if state is None:
        state = mlstm_init_state(B, H, dk, di, W, dt, x.device, dv=dv)
    h_in = spmd.region_grad_sum(rms_norm(params["norm"], x), region)
    x_in, z = torch.chunk(h_in @ params["w_up"].to(dt), 2, dim=-1)
    x_c, _ = causal_conv1d(params["conv"], x_in,
                           _rows(state.conv, H, r * dv, (r + 1) * dv))
    x_in, x_c = _heads_whole(region, H, x_in, x_c)
    # the conv state keeps the last W-1 inputs, as causal_conv1d does
    conv_new = torch.cat([state.conv, x_in], 1)[:, -(W - 1):] \
        if W > 1 else state.conv
    q, k = (t.reshape(B, S, H, dk).transpose(1, 2).float().contiguous()
            for t in _heads_whole(region, H, x_c @ params["wq"].to(dt),
                                  x_c @ params["wk"].to(dt)))
    v = (x_in @ params["wv"].to(dt)).reshape(B, S, H, dv) \
        .transpose(1, 2).float().contiguous()
    log_i, log_f = _mlstm_gates(params, x_c, H)
    if decode:
        h, C, n, m = _mlstm_step(q[:, :, 0] * dk ** -0.5, k[:, :, 0],
                                 v[:, :, 0], log_i[..., 0], log_f[..., 0],
                                 state)
        h = h[:, :, None]
    else:
        L = min(chunk, S)
        if S % L:
            raise ValueError(f"seq {S} not divisible by chunk {L}")
        h, C, n, m = ops.mlstm_chunkwise(
            q, k, v, log_i, log_f, state.C.contiguous(),
            state.n.contiguous(), state.m.contiguous(), chunk=L)
    h = h.transpose(1, 2).reshape(B, S, H * dv).to(dt)
    h = spmd.region_rms_norm(params["gnorm"]["scale"], h, region, di)
    out = (h * F.silu(z)) @ params["w_down"].to(dt)
    return x + spmd.region_sum(out, region), MLSTMState(C, n, m, conv_new)


# ================================================================= sLSTM ===
class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B,H,dh)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor   # (B,H,dh)


def init_slstm(gen: torch.Generator, d_model: int, num_heads: int):
    dh = d_model // num_heads
    dev = gen.device
    return {
        "norm": {"scale": torch.ones((d_model,), device=dev)},
        "w": lecun_init(gen, (d_model, 4 * d_model)),       # i,f,z,o preacts
        "r": lecun_init(gen, (num_heads, dh, 4 * dh), fan_in=dh),  # recurrent
        "b": torch.zeros((4 * d_model,), device=dev),
        "gnorm": {"scale": torch.ones((d_model,), device=dev)},
        "w_up": lecun_init(gen, (d_model, 2 * d_model)),
        "w_down": lecun_init(gen, (d_model, d_model)),
    }


def slstm_init_state(batch: int, num_heads: int, dh: int,
                     device="cpu") -> SLSTMState:
    return SLSTMState(*[torch.zeros((batch, num_heads, dh),
                                    dtype=torch.float32, device=device)
                        for _ in range(4)])


def _slstm_cell(r, x_pre, state: SLSTMState, num_heads: int):
    """x_pre: (B, 4*D) input preactivations for one timestep; ``r`` the
    recurrent weight (H, dh, 4*dh) in f32."""
    B = x_pre.shape[0]
    dh = x_pre.shape[-1] // 4 // num_heads
    rec = torch.einsum("bhd,hde->bhe", state.h, r)
    pre = x_pre.float().reshape(B, num_heads, 4 * dh) + rec
    i_p, f_p, z_p, o_p = torch.split(pre, dh, dim=-1)
    log_f = F.logsigmoid(f_p)
    m_new = torch.maximum(log_f + state.m, i_p)
    i_g = torch.exp(i_p - m_new)
    f_g = torch.exp(log_f + state.m - m_new)
    c = f_g * state.c + i_g * torch.tanh(z_p)
    n = f_g * state.n + i_g
    h = torch.sigmoid(o_p) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(c, n, h, m_new)


def slstm_apply(params, x, *, num_heads: int, state: SLSTMState = None,
                region=None):
    """sLSTM block (inherently sequential).  x: (B,S,D) -> (out, state).
    Its recurrence runs on the heads ``params["r"]`` holds.  Inside a
    sharded step's local region ``region`` ``params`` are the rank's cut
    (:func:`slstm_cuts`): the input projection ``w`` column-parallel (its
    columns are head-major), ``w_up`` column-parallel and ``w_down``
    row-parallel, summed over ``model``.  The recurrence then runs on the
    rank's heads, its hidden states gathered once after the time loop, or
    on all of them on every rank, the preactivations gathered once before
    it; no collective runs inside the loop.  Gradients are each rank's
    share but the input norm's, as in :func:`_mlstm`.  ``r`` is read in
    f32, cast once before the loop: a cast inside it would be a new copy
    every step, each saved for the backward."""
    from repro_torch.dist import spmd
    B, S, D = x.shape
    H, dh = num_heads, D // num_heads
    Hl = params["r"].shape[0]
    dt = x.dtype
    h_in = spmd.region_grad_sum(rms_norm(params["norm"], x), region)
    x_pre = h_in @ params["w"].to(dt) + params["b"].to(dt)
    if Hl == H:
        x_pre = spmd.region_gather(x_pre, region, 2)
    if state is None:
        state = slstm_init_state(B, Hl, dh, x.device)
    r = params["r"].float()
    hs = []
    for t in range(S):
        state = _slstm_cell(r, x_pre[:, t], state, Hl)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).reshape(B, S, Hl * dh).to(dt)
    if Hl < H:
        h = spmd.region_gather(h, region, 2)
    h = rms_norm(params["gnorm"], h)
    up, gate = torch.chunk(h @ params["w_up"].to(dt), 2, dim=-1)
    out = (up * F.gelu(gate, approximate="tanh")) @ params["w_down"].to(dt)
    return x + spmd.region_sum(out, region), state


@functools.lru_cache(maxsize=None)
def slstm_cuts(m: int, num_heads: int, d_model: int, heads: bool) -> dict:
    """The ``spmd.Cut`` of each weight of an sLSTM block (``norm`` aside)
    for ``m`` ``model`` ranks: rank ``r`` computes with the r-th block of
    ``w``'s columns (and ``b``'s), of each half of ``w_up``'s and of
    ``w_down``'s rows, and with ``heads`` the r-th block of the recurrent
    heads (else all of them); the gated norm whole."""
    from repro_torch.dist.spmd import Cut
    D = d_model
    cols = np.arange(4 * D).reshape(m, -1)
    cs = np.arange(D).reshape(m, -1)
    return {"w": Cut(1, cols), "b": Cut(0, cols),
            "r": Cut(0, np.arange(num_heads).reshape(m, -1))
            if heads else None,
            "gnorm": None, "w_up": Cut(1, np.concatenate([cs, D + cs], 1)),
            "w_down": Cut(0, cs)}


# ================================================================= Mamba2 ==
class Mamba2State(NamedTuple):
    h: torch.Tensor      # (B,H,dh,N) ssm state
    conv: torch.Tensor   # (B,W-1,C) conv state


def init_mamba2(gen: torch.Generator, d_model: int, state_dim: int, *,
                expansion: int = 2, head_dim: int = 64, conv_width: int = 4):
    di = d_model * expansion
    nheads = di // head_dim
    conv_ch = di + 2 * state_dim
    dev = gen.device
    return {
        "norm": {"scale": torch.ones((d_model,), device=dev)},
        # projects to [z(di), x(di), B(N), C(N), dt(nheads)]
        "w_in": lecun_init(gen, (d_model, 2 * di + 2 * state_dim + nheads)),
        "conv": init_conv1d(gen, conv_ch, conv_width),
        "A_log": torch.zeros((nheads,), device=dev),       # A = -exp(A_log)
        "D": torch.ones((nheads,), device=dev),
        "dt_bias": torch.zeros((nheads,), device=dev),
        "gnorm": {"scale": torch.ones((di,), device=dev)},
        "w_out": lecun_init(gen, (di, d_model)),
    }


def mamba2_init_state(batch: int, di: int, state_dim: int, head_dim: int = 64,
                      conv_width: int = 4, dtype=torch.float32,
                      device="cpu") -> Mamba2State:
    nheads = di // head_dim
    return Mamba2State(
        h=torch.zeros((batch, nheads, head_dim, state_dim),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, conv_width - 1, di + 2 * state_dim),
                         dtype=dtype, device=device))


def _mamba2_proj(params, x, di, state_dim, nheads):
    zxbcdt = x @ params["w_in"].to(x.dtype)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * state_dim]
    dt_pre = zxbcdt[..., -nheads:]
    return z, xbc, dt_pre


def mamba2_apply(params, x, *, state_dim: int, state: Mamba2State = None,
                 expansion: int = 2, head_dim: int = 64, chunk: int = 256,
                 region=None):
    """Mamba2 (SSD) block.  x: (B,S,D) -> (out, new_state).  Chunks of
    ``min(chunk, S)`` steps, which must divide S, from ``state`` (zero if
    None).  Inside a chunk the decay weights ``exp(b_t - b_s)`` are taken
    only on and below the diagonal (the masked exponent is -inf), where
    the reference takes them everywhere and masks after: the same values,
    and no overflow above the diagonal.  Inside a sharded step's local
    region ``region`` the block runs on the rank's heads, or with a state
    on the rank's part of every head's dim, ``params`` cut to them
    (:func:`_mamba2`)."""
    return _mamba2(params, x, state_dim, expansion, head_dim, chunk, state,
                   region)


def _mamba2_scan(params, xbc_c, dt_pre, h, chunk: int):
    """The SSD chunk scan of the convolved (B, S, di + 2N) ``xbc_c`` from
    state ``h`` (B, H, dh, N), heads as ``params``' ``A_log``, ``D`` and
    ``dt_bias`` give them.  Returns (y (B, H, S, dh) f32, the end
    state)."""
    B, S, _ = xbc_c.shape
    nheads, head_dim, N = h.shape[1], h.shape[2], h.shape[3]
    di = nheads * head_dim
    xs = xbc_c[..., :di].float()
    Bmat = xbc_c[..., di:di + N].float()                       # (B,S,N)
    Cmat = xbc_c[..., di + N:].float()
    dt = F.softplus(dt_pre.float() + params["dt_bias"])        # (B,S,H)
    A = -torch.exp(params["A_log"])                            # (H,)
    log_decay = (dt * A).transpose(1, 2)                       # (B,H,S)
    xh = xs.reshape(B, S, nheads, head_dim).transpose(1, 2)    # (B,H,S,dh)
    xh_dt = xh * dt.transpose(1, 2)[..., None]

    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    causal = torch.ones((L, L), dtype=torch.bool,
                        device=xbc_c.device).tril()
    ys = []
    for c in range(S // L):
        sl = slice(c * L, (c + 1) * L)
        xc, bc, cc = xh_dt[:, :, sl], Bmat[:, sl], Cmat[:, sl]
        b = torch.cumsum(log_decay[:, :, sl], dim=-1)          # (B,H,L)
        # intra: scores[t,s] = C_t . B_s * exp(b_t - b_s), s <= t
        lw = b[..., :, None] - b[..., None, :]
        w = torch.exp(torch.where(causal, lw, float("-inf")))  # (B,H,L,L)
        cb = cc @ bc.transpose(1, 2)                           # (B,L,L)
        y_intra = (w * cb[:, None]) @ xc
        # inter: read the carried state
        y_inter = torch.exp(b)[..., None] * (cc[:, None]
                                             @ h.transpose(-1, -2))
        ys.append(y_intra + y_inter)
        # state update: decay each step's contribution to the chunk end
        bl = b[..., -1:]                                       # (B,H,1)
        w_state = torch.exp(bl - b)
        h = torch.exp(bl)[..., None] * h + \
            (xc * w_state[..., None]).transpose(-1, -2) @ bc[:, None]
    y = torch.cat(ys, dim=2)                                   # (B,H,S,dh)
    return y + params["D"][None, :, None, None] * xh, h


def _mamba2_step(params, xbc_c, dt_pre, h):
    """One exact recurrent step of the convolved (B, di + 2N) ``xbc_c``
    and ``dt_pre`` (B, H) from state ``h`` (B, H, dh, N).  Returns (y (B,
    H, dh) f32, the new state)."""
    B = xbc_c.shape[0]
    nheads, head_dim, N = h.shape[1], h.shape[2], h.shape[3]
    di = nheads * head_dim
    xs = xbc_c[:, :di].float()
    Bv = xbc_c[:, di:di + N].float()
    Cv = xbc_c[:, di + N:].float()
    dt = F.softplus(dt_pre.float() + params["dt_bias"])        # (B,H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)
    xh = xs.reshape(B, nheads, head_dim)
    h_new = decay[..., None, None] * h + \
        (xh * dt[..., None])[..., None] * Bv[:, None, None, :]
    y = (h_new @ Cv[:, None, :, None])[..., 0] \
        + params["D"][None, :, None] * xh
    return y, h_new


@functools.lru_cache(maxsize=None)
def mamba2_cuts(m: int, di: int, state_dim: int, head_dim: int,
                by_dim: bool) -> dict:
    """The ``spmd.Cut`` of each weight of a Mamba2 block (``norm`` aside)
    for ``m`` ``model`` ranks: rank ``r`` computes with the r-th block of
    the heads, or (``by_dim``, with a state) of every head's dim p, the
    split ``partition.cache_specs`` gives ``h`` (B, H, p, N): those z, x
    and dt columns of ``w_in`` (B and C whole), those conv channels (B and
    C whole), those heads' ``A_log``, ``D`` and ``dt_bias``, those
    channels of the gated norm and rows of ``w_out``."""
    from repro_torch.dist.spmd import Cut
    H, N, P = di // head_dim, state_dim, head_dim

    def share(r):
        if by_dim:
            return slice(None), slice(r * P // m, (r + 1) * P // m)
        return slice(r * H // m, (r + 1) * H // m), slice(None)
    ix = np.stack([_grid(H, P, *share(r)) for r in range(m)])
    hx = np.stack([np.arange(H)[share(r)[0]] for r in range(m)])
    bc = np.broadcast_to(np.arange(2 * N), (m, 2 * N))
    ch = np.concatenate([ix, di + bc], 1)
    heads = None if by_dim else Cut(0, hx)
    return {"w_in": Cut(1, np.concatenate(
                [ix, di + ix, 2 * di + bc, 2 * di + 2 * N + hx], 1)),
            "conv": {"w": Cut(1, ch), "b": Cut(0, ch)},
            "A_log": heads, "D": heads, "dt_bias": heads,
            "gnorm": {"scale": Cut(0, ix)}, "w_out": Cut(0, ix)}


def _mamba2(params, x, N: int, expansion: int, head_dim: int, chunk: int,
            state, region, decode: bool = False):
    """The Mamba2 block (``decode``: its exact recurrent step) on the
    heads and head rows ``params`` hold: all of them, or in the local
    region ``region`` the rank's heads, or with a state the rank's part p
    of every head's dim, the split of ``h`` (B, H, p, N) that ``state``
    then holds (:func:`mamba2_cuts`).  The input projection runs on the
    rank's z, x and dt columns with B and C whole, the conv on those
    channels (a state's x channels of the conv's new state gathered over
    ``model`` after, so every rank keeps the whole conv state), the scan
    on the rank's heads or head rows, the gated norm over all of them
    through one sum over ``model`` of a value a row, and ``w_out``'s
    output is summed over ``model``.  The input's gradient is summed over
    ``model`` where it enters the projection, so every weight's gradient
    is this rank's share but the input norm's.  Without a state the
    returned conv state holds the rank's channels."""
    from repro_torch.dist import spmd
    B, S, D = x.shape
    di = D * expansion
    H = di // head_dim
    Hl = params["A_log"].shape[0]
    dl = params["gnorm"]["scale"].shape[0]
    pl = dl // Hl
    r = 0 if region is None else region.rank
    h_in = spmd.region_grad_sum(rms_norm(params["norm"], x), region)
    z, xbc, dt_pre = _mamba2_proj(params, h_in, dl, N, Hl)
    prev = None
    if state is not None:
        prev = torch.cat([_rows(state.conv[..., :di], H, r * pl,
                                (r + 1) * pl), state.conv[..., di:]], -1)
    xbc_c, tail = causal_conv1d(params["conv"], xbc, prev)
    h0 = state.h if state is not None else torch.zeros(
        (B, Hl, pl, N), dtype=torch.float32, device=x.device)
    if decode:
        y, h = _mamba2_step(params, xbc_c[:, 0], dt_pre[:, 0], h0)
        y = y.reshape(B, 1, dl)
    else:
        y, h = _mamba2_scan(params, xbc_c, dt_pre, h0, chunk)
        y = y.transpose(1, 2).reshape(B, S, dl)
    y = spmd.region_rms_norm(params["gnorm"]["scale"], y.to(x.dtype),
                             region, di)
    out = (y * F.silu(z)) @ params["w_out"].to(x.dtype)
    if state is not None:
        xs, = _heads_whole(region, H, tail[..., :dl])
        tail = torch.cat([xs, tail[..., dl:]], -1)
    return x + spmd.region_sum(out, region), Mamba2State(h, tail)


def mamba2_decode_step(params, x, state: Mamba2State, *, state_dim: int,
                       expansion: int = 2, head_dim: int = 64, region=None):
    """Exact recurrent single step.  x: (B,1,D).  With ``region``, on the
    rank's part of every head's dim (:func:`_mamba2`)."""
    return _mamba2(params, x, state_dim, expansion, head_dim, 1, state,
                   region, decode=True)
