"""Bytes and operations of one call of each hand-written kernel, and the
least time an H100 could take for them.

One copy of the formulas behind the bound column of the kernel table:
``chip_smoke.py`` and ``kernel_times.py`` compute each kernel's bound
from them, and the op counter (``launch/hlo_analysis.py``) adds them
up, by kernel name, for every kernel a traced step calls.  Bytes count
each input read once and each output written once; operations count what
the function needs on these inputs.  Each function returns ``(bytes,
ops)``: ``ops`` a count, or for the env step a list of ``(count, peak)``
pairs whose times add.

The peaks are NVIDIA's data sheet figures for the H100 SXM (dense, at its
700 W limit).
"""
from __future__ import annotations

PEAK_BYTES = 3.35e12     # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12         # H100 SXM fp32 outside the tensor cores, flop/s
PEAK_BF16 = 989e12       # H100 SXM bf16 tensor cores, dense, flop/s
PEAK_TF32 = 495e12       # H100 SXM TF32 tensor cores, dense, flop/s
# f32 accuracy on the TF32 tensor cores takes three passes (3xTF32)
PEAK_3XTF32 = PEAK_TF32 / 3


def env_mega_step(N, J, obs_dim, substeps):
    """Bytes, and the operations as (count, peak) pairs whose times add:
    the observation projection in three TF32 passes on the tensor cores,
    the rest on the fp32 pipe."""
    R = 6 + 4 * J + 3
    # reads q, qd, action (N,J) f32, root (N,6), t/seed/resets (N,) i32 and
    # the constants; writes q, qd, prev_action, root, t, resets, obs,
    # reward, done.  prev_action is an input the step never reads.
    bytes_ = 4 * (3 * N * J + 6 * N + 3 * N + R * obs_dim + 3 * J) \
        + 4 * (3 * N * J + 6 * N + 2 * N + N * obs_dim + 2 * N)
    # observation projection, then tanh and ~32 fp32 ops a joint a
    # substep (coupling, gravity, qdd, clip, Euler, tip cumsum, thrust
    # sums, counting each sin/cos as one) plus ~30 a substep for the root
    proj = 2 * N * R * obs_dim
    rest = N * obs_dim + N * substeps * (32 * J + 30)
    return bytes_, [(proj, PEAK_3XTF32), (rest, PEAK_F32)]


def gae_norm(T, N):
    # reads r, v, d (T,N) and last (N); writes adv, ret (T,N); ~13 ops an
    # element (scan 7, mean and centred variance 4, normalise 2)
    return 4 * (3 * T * N + N + 2 * T * N), 13 * T * N


def policy_mlp(dims, N):
    pairs = list(zip(dims[:-1], dims[1:]))
    bytes_ = 4 * (N * dims[0] + sum(a * b + b for a, b in pairs)
                  + N * dims[-1])
    ops_ = sum(2 * N * a * b + 2 * N * b for a, b in pairs)
    return bytes_, ops_


def nstep_returns(T, N):
    # reads r, d (T,N) and bootstrap (N); writes G (T,N); 4 ops an element
    return 4 * (3 * T * N + N), 4 * T * N


def pack_channels(T, N, obs_dim, act_dim):
    # every payload element read once and written once; no arithmetic
    return 2 * (4 * (T * N * (obs_dim + act_dim + 2) + N) + 4), 0


def paged_attention(q, k_pages, v_pages, slot_pos, table, positions,
                    window=None):
    """Bytes and operations of one paged decode call on these inputs:
    q and out, the table and positions, and each row's mapped pages that
    can hold a visible key, those before a ``window`` left out (k, v and
    slot positions of the page, read once); ~4 * H * hd flops per visible
    key.  Where the data cannot be read (a traced step's fake tensors),
    every row attends its whole table, or the most pages a ``window`` of
    keys can span: the most the call could need."""
    from torch._subclasses.fake_tensor import FakeTensor
    B, H, hd = q.shape
    N, P, KH, _ = k_pages.shape
    M = table.shape[1]
    es = q.element_size()
    bytes_ = 2 * B * H * hd * es + table.numel() * 4 + B * 4
    if isinstance(q, FakeTensor) or isinstance(table, FakeTensor):
        pages, keys = M, M * P
        if window is not None:
            # W consecutive positions span at most ceil((W - 1) / P) + 1
            # pages
            pages = min(M, -(-(int(window) - 1) // P) + 1)
            keys = min(keys, int(window))
        return bytes_ + B * pages * (2 * P * KH * hd * es + P * 4), \
            B * keys * 4 * H * hd
    # measurement code: it reads the data to count what the call needs
    # repro: allow(host-sync-in-hot-path)
    sp, table, pos = slot_pos.cpu(), table.cpu(), positions.cpu()
    keys = 0
    for b in range(B):
        qp = int(pos[b])
        if qp < 0:
            continue
        lo = 0 if window is None else max(qp - int(window) + 1, 0)
        for v in range(lo // P, qp // P + 1):
            pid = int(table[b, v])
            if pid >= 0:
                bytes_ += 2 * P * KH * hd * es + P * 4
                sl = sp[pid]
                keys += int(((sl >= lo) & (sl <= qp)).sum())
    return bytes_, keys * 4 * H * hd


def flash_attention(B, S, H, KH, hd, es, causal=True, window=None):
    # q, k, v read once, out written once; QK^T and PV over the visible
    # pairs, 4 * hd flops each: query i sees keys j <= i (causal) and
    # j > i - window
    W = S if window is None else min(int(window), S)
    if causal:
        per = W * (W + 1) // 2 + (S - W) * W
    else:
        per = S * S - (S - W) * (S - W + 1) // 2
    return (es * (2 * B * S * H * hd + 2 * B * S * KH * hd),
            4 * hd * B * H * per)


def mlstm_chunkwise(B, H, S, dk, L, dv=None):
    # q, k (B,H,S,dk), v, h (B,H,S,dv) (dv = dk when None), the gates
    # (B,H,S), the state in and out; per (b, h, chunk) what the function
    # needs: the causal halves of q k^T (L^2 dk) and scores v (L^2 dv; the
    # denominator's in-chunk part is the score rows' sums), 2 L dv dk each
    # for q C^T and the C update, and 2 L dk each for q . n and the n
    # update
    dv = dk if dv is None else dv
    bytes_ = 4 * (2 * B * H * S * (dk + dv) + 2 * B * H * S
                  + 2 * (B * H * dv * dk + B * H * dk + B * H))
    ops_ = B * H * (S // L) * (L * L * (dk + dv) + 4 * L * dv * dk
                               + 4 * L * dk)
    return bytes_, ops_


def bound_ms(bytes_, ops_, peak_ops=PEAK_F32):
    """The larger of the bytes' time and the operations' time; ``ops_``
    is a count at ``peak_ops``, or a list of (count, peak) pairs whose
    times add."""
    tb = bytes_ / PEAK_BYTES * 1e3
    if isinstance(ops_, list):
        to = sum(o / p for o, p in ops_) * 1e3
    else:
        to = ops_ / peak_ops * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def op_count(ops_):
    return sum(o for o, _ in ops_) if isinstance(ops_, list) else ops_
