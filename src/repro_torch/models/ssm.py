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

Mamba2 (SSD, zamba2's backbone) runs its chunked scan with a carried
``(h, conv)`` state as a Python loop over chunks of plain batched matrix
products, as the reference's ``lax.scan`` of einsums (the reference has no
Pallas kernel for it), and decodes with the exact recurrent update.
"""
from __future__ import annotations

from typing import NamedTuple

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
                     device="cpu") -> MLSTMState:
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        C=torch.zeros((batch, num_heads, dh, dh), **f32),
        n=torch.zeros((batch, num_heads, dh), **f32),
        m=torch.zeros((batch, num_heads), **f32),     # 0, not -inf
        conv=torch.zeros((batch, conv_width - 1, di), dtype=dtype,
                         device=device))


def _mlstm_chunk(q, k, v, log_i, log_f, state_C, state_n, state_m):
    """One chunk of the stabilized chunkwise mLSTM.

    q,k,v: (B,H,L,dh); log_i/log_f: (B,H,L).
    Returns (h (B,H,L,dh), C', n', m')."""
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
                chunk: int = 256, expansion: int = 2):
    """mLSTM block.  x: (B,S,D) -> (out, new_state).  The chunk scan is
    one ``ops.mlstm_chunkwise`` call from ``state`` (zero if None) over
    chunks of ``min(chunk, S)`` steps, which must divide S."""
    B, S, D = x.shape
    di = D * expansion
    dh = di // num_heads
    dt = x.dtype
    h_in = rms_norm(params["norm"], x)
    up = h_in @ params["w_up"].to(dt)
    x_in, z = torch.chunk(up, 2, dim=-1)
    conv_state = state.conv if state is not None else None
    x_c, conv_new = causal_conv1d(params["conv"], x_in, conv_state)

    def heads(t, w):
        return (t @ w.to(t.dtype)).reshape(B, S, num_heads, dh) \
            .transpose(1, 2).float().contiguous()

    q = heads(x_c, params["wq"])
    k = heads(x_c, params["wk"])
    v = heads(x_in, params["wv"])
    if_pre = (x_c @ params["w_if"].to(dt)) + params["b_if"].to(dt)
    if_pre = if_pre.reshape(B, S, 2, num_heads).permute(0, 3, 1, 2).float()
    log_i = if_pre[..., 0].contiguous()                      # (B,H,S)
    log_f = F.logsigmoid(if_pre[..., 1]).contiguous()

    if state is None:
        state = mlstm_init_state(B, num_heads, dh, di,
                                 params["conv"]["w"].shape[0], dt, x.device)
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    h, C, n, m = ops.mlstm_chunkwise(
        q, k, v, log_i, log_f, state.C.contiguous(), state.n.contiguous(),
        state.m.contiguous(), chunk=L)
    h = h.transpose(1, 2).reshape(B, S, di).to(dt)
    h = rms_norm(params["gnorm"], h)
    out = (h * F.silu(z)) @ params["w_down"].to(dt)
    return x + out, MLSTMState(C, n, m, conv_new)


def mlstm_decode_step(params, x, state: MLSTMState, *, num_heads: int,
                      expansion: int = 2):
    """Exact recurrent single step.  x: (B,1,D)."""
    B, _, D = x.shape
    di = D * expansion
    dh = di // num_heads
    dt = x.dtype
    h_in = rms_norm(params["norm"], x)
    up = h_in @ params["w_up"].to(dt)
    x_in, z = torch.chunk(up, 2, dim=-1)
    x_c, conv_new = causal_conv1d(params["conv"], x_in, state.conv)

    def head(t, w):
        return (t @ w.to(t.dtype)).reshape(B, num_heads, dh).float()

    q = head(x_c[:, 0], params["wq"]) * dh ** -0.5
    k = head(x_c[:, 0], params["wk"])
    v = head(x_in[:, 0], params["wv"])
    if_pre = (x_c[:, 0] @ params["w_if"].to(dt)) + params["b_if"].to(dt)
    if_pre = if_pre.reshape(B, 2, num_heads).float()
    log_i, log_f = if_pre[:, 0], F.logsigmoid(if_pre[:, 1])
    m_new = torch.maximum(log_f + state.m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + state.m - m_new)
    C = f_s[..., None, None] * state.C + i_s[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", v, k)
    n = f_s[..., None] * state.n + i_s[..., None] * k
    num = torch.einsum("bhe,bhde->bhd", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, di).to(dt)
    h = rms_norm(params["gnorm"], h)
    out = (h * F.silu(z)) @ params["w_down"].to(dt)
    return x + out, MLSTMState(C, n, m_new, conv_new)


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


def _slstm_cell(params, x_pre, state: SLSTMState, num_heads: int):
    """x_pre: (B, 4*D) input preactivations for one timestep."""
    B = x_pre.shape[0]
    dh = x_pre.shape[-1] // 4 // num_heads
    rec = torch.einsum("bhd,hde->bhe", state.h, params["r"].float())
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


def slstm_apply(params, x, *, num_heads: int, state: SLSTMState = None):
    """sLSTM block (inherently sequential).  x: (B,S,D) -> (out, state)."""
    B, S, D = x.shape
    dt = x.dtype
    if state is None:
        state = slstm_init_state(B, num_heads, D // num_heads, x.device)
    h_in = rms_norm(params["norm"], x)
    x_pre = h_in @ params["w"].to(dt) + params["b"].to(dt)
    hs = []
    for t in range(S):
        state = _slstm_cell(params, x_pre[:, t], state, num_heads)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).reshape(B, S, D).to(dt)
    h = rms_norm(params["gnorm"], h)
    up, gate = torch.chunk(h @ params["w_up"].to(dt), 2, dim=-1)
    out = (up * F.gelu(gate, approximate="tanh")) @ params["w_down"].to(dt)
    return x + out, state


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
                 expansion: int = 2, head_dim: int = 64, chunk: int = 256):
    """Mamba2 (SSD) block.  x: (B,S,D) -> (out, new_state).  Chunks of
    ``min(chunk, S)`` steps, which must divide S, from ``state`` (zero if
    None).  Inside a chunk the decay weights ``exp(b_t - b_s)`` are taken
    only on and below the diagonal (the masked exponent is -inf), where
    the reference takes them everywhere and masks after: the same values,
    and no overflow above the diagonal."""
    B, S, D = x.shape
    di = D * expansion
    nheads = di // head_dim
    N = state_dim
    h_in = rms_norm(params["norm"], x)
    z, xbc, dt_pre = _mamba2_proj(params, h_in, di, N, nheads)
    conv_state = state.conv if state is not None else None
    xbc_c, conv_new = causal_conv1d(params["conv"], xbc, conv_state)
    xs = xbc_c[..., :di].float()
    Bmat = xbc_c[..., di:di + N].float()                       # (B,S,N)
    Cmat = xbc_c[..., di + N:].float()
    dt = F.softplus(dt_pre.float() + params["dt_bias"])        # (B,S,H)
    A = -torch.exp(params["A_log"])                            # (H,)
    log_decay = (dt * A).transpose(1, 2)                       # (B,H,S)
    xh = xs.reshape(B, S, nheads, head_dim).transpose(1, 2)    # (B,H,S,dh)
    xh_dt = xh * dt.transpose(1, 2)[..., None]

    if state is None:
        state = mamba2_init_state(B, di, N, head_dim,
                                  params["conv"]["w"].shape[0], x.dtype,
                                  x.device)
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    h = state.h
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
    y = y + params["D"][None, :, None, None] * xh
    y = y.transpose(1, 2).reshape(B, S, di).to(x.dtype)
    y = rms_norm(params["gnorm"], y)
    out = (y * F.silu(z)) @ params["w_out"].to(x.dtype)
    return x + out, Mamba2State(h, conv_new)


def mamba2_decode_step(params, x, state: Mamba2State, *, state_dim: int,
                       expansion: int = 2, head_dim: int = 64):
    """Exact recurrent single step.  x: (B,1,D)."""
    B, _, D = x.shape
    di = D * expansion
    nheads = di // head_dim
    N = state_dim
    h_in = rms_norm(params["norm"], x)
    z, xbc, dt_pre = _mamba2_proj(params, h_in, di, N, nheads)
    xbc_c, conv_new = causal_conv1d(params["conv"], xbc, state.conv)
    xs = xbc_c[:, 0, :di].float()
    Bv = xbc_c[:, 0, di:di + N].float()
    Cv = xbc_c[:, 0, di + N:].float()
    dt = F.softplus(dt_pre[:, 0].float() + params["dt_bias"])  # (B,H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)
    xh = xs.reshape(B, nheads, head_dim)
    h_new = decay[..., None, None] * state.h + \
        (xh * dt[..., None])[..., None] * Bv[:, None, None, :]
    y = (h_new @ Cv[:, None, :, None])[..., 0] \
        + params["D"][None, :, None] * xh
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(params["gnorm"], y)
    out = (y * F.silu(z)) @ params["w_out"].to(x.dtype)
    return x + out, Mamba2State(h_new, conv_new)
