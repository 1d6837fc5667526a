"""The arithmetic of the hand-written kernels' designs, emulated in plain
torch on the CPU: the split products of the tensor-core kernels and the
split-KV merge of paged decode.  These tests pin the design's numerics,
the reason for each split, not the kernels' own: the kernels run only on a
CUDA card, where ``chip_smoke.py`` holds them against their plain
versions.  The emulation differs from the kernels in what does not bear on
the split (``torch.tanh`` and the softmax's own loop).

* ``csrc/fused_policy_mlp.cu`` runs 3xTF32: each operand x splits into
  ``x_hi = tf32(x)`` and ``x_lo = x - x_hi``, of which the MMA reads the
  TF32 part (emulated here as truncation, the coarser of the two ways it
  could read it), and the f32 accumulator takes ``lo*hi + hi*lo +
  hi*hi``.  At ShadowHand's widths that product is
  within 1e-5 of the f64 one, and one TF32 pass is not.
* ``csrc/flash_attention.cu`` (bf16) multiplies P by V as ``P_hi =
  bf16(P)`` plus ``P_lo = bf16(P - P_hi)``, two bf16 products into one
  f32 accumulator.  With that split the output stays inside the card
  check's gate (each element within one bf16 ulp of its own magnitude,
  plus 2^-14); the error of a single bf16 P at the same inputs is what
  ``python tests/test_torch_split_precision.py`` prints.
* ``csrc/mlstm_chunkwise.cu`` runs its four products (q k^T, P v, q C^T
  and the C update (w_c v)^T k) in 3xTF32 too.  At xlstm-1.3b's dh 512 and
  chunk 256 that keeps h and the final (C, n, m) within 1e-4 of each
  output's largest magnitude (the card's gate), and one TF32 pass does not.
* ``csrc/paged_decode.cu`` splits each row's visible pages into NSPLIT
  ranges, runs an online softmax over each, and merges the partials
  (m, l, acc) with weights exp(m_s - max m); a range that saw no key
  carries m = -1e30 and l = 0 and adds nothing, and an all-masked row
  comes out exactly 0.

TF32 rounding is emulated by masking the mantissa as the kernel does it:
add half of the 13 dropped bits to the magnitude and clear them, which is
round to nearest with ties away from zero (as ``cvt.rna.tf32.f32``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.utils import bf16_ulps

SHADOWHAND_TRUNK = (211, 512, 512, 512, 256)
LOG2E = 1.4426950408889634
BK = 64                    # keys a tile of the bf16 kernel at these shapes


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 explicit mantissa bits), nearest, ties away
    from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The TF32 part of f32 bits: the 13 low mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32_trunc(x - hi)


def matmul_3xtf32(a, b):
    """The kernel's three passes, each product exact in f32 (11-bit
    operands), summed in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def matmul_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def _layer(din, dout, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, din)).astype(np.float32)
    w = (rng.standard_normal((din, dout)) * np.sqrt(2.0 / din)).astype(
        np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _trunk(dims, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, (n, dims[0]))
                         .astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
                           .astype(np.float32))
          for a, b in zip(dims, dims[1:])]
    bs = [torch.from_numpy((rng.standard_normal(b) * 0.1).astype(np.float32))
          for b in dims[1:]]
    return x, ws, bs


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-3])
    got = tf32(x)
    # ties away from zero, both signs; below half an ulp rounds down
    assert got[0] == 1.0 and got[1] == 1.0 + 2.0 ** -10
    assert got[2] == 1.0 + 2.0 ** -10 and got[3] == -(1.0 + 2.0 ** -10)
    assert got[4] == 1.0
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert float((got[5] - x[5]).abs()) <= 2.0 ** -11 * float(x[5])


@pytest.mark.parametrize("din,dout", sorted(set(
    zip(SHADOWHAND_TRUNK, SHADOWHAND_TRUNK[1:]))))
def test_three_tf32_passes_match_f64_one_pass_does_not(din, dout):
    """One ShadowHand trunk layer at N = 64: the 3-pass product within
    1e-5 of the f64 product; the 1-pass product further."""
    x, w = _layer(din, dout, 64, seed=din * 1000 + dout)
    want = x.double() @ w.double()
    e3 = float((matmul_3xtf32(x, w).double() - want).abs().max())
    e1 = float((matmul_1xtf32(x, w).double() - want).abs().max())
    assert e3 <= 1e-5, e3
    assert e1 > 1e-5, e1
    assert e1 > 30 * e3, (e1, e3)


def test_three_pass_trunk_within_the_card_check_of_the_plain_version():
    """The whole ShadowHand trunk with every layer's product in 3 passes
    stays within the card's 1e-4 trunk check of the plain version (and
    within 1e-5 of it here)."""
    x, ws, bs = _trunk(SHADOWHAND_TRUNK, 64, seed=7)
    h = x
    for w, b in zip(ws, bs):
        h = torch.tanh(matmul_3xtf32(h, w) + b)
    want = ref.policy_mlp_ref(x.double(), [w.double() for w in ws],
                              [b.double() for b in bs])
    assert float((h.double() - want).abs().max()) <= 1e-5


def flash_emulated(q, k, v, *, causal=True, split_p=True):
    """The bf16 kernel's arithmetic: f32 scores of bf16 q and k (exact
    products), scaled in f32, online softmax in base 2 over tiles of BK
    keys, and P V with P as bf16 P_hi (+ bf16 P_lo when ``split_p``)
    against bf16 v, accumulated in f32; the output rounded to bf16."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    qf = q.float().reshape(B, S, KH, G, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]     # (B, KH, 1, S, hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((B, KH, G, S, 1), -1e30)
    l = torch.zeros((B, KH, G, S, 1))
    o = torch.zeros((B, KH, G, S, hd))
    qpos = torch.arange(S)[:, None]
    for j0 in range(0, S, BK):
        kt, vt = kf[..., j0:j0 + BK, :], vf[..., j0:j0 + BK, :]
        x = (qf @ kt.transpose(-1, -2)) * hd ** -0.5 * LOG2E
        if causal:
            kpos = torch.arange(j0, j0 + kt.shape[-2])[None, :]
            x = torch.where(kpos <= qpos, x, -torch.inf)
        mn = torch.maximum(m, x.amax(-1, keepdim=True))
        c = torch.exp2(m - mn)
        p = torch.exp2(x - mn)
        l = l * c + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float() if split_p else 0.0 * hi
        o = o * c + (lo @ vt + hi @ vt)
        m = mn
    o = o / l
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(torch.bfloat16)


def _attention_inputs(seed, shape=(1, 128, 16, 8, 128)):
    B, S, H, KH, hd = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((B, S, h, hd))
                                  .astype(np.float32)).to(torch.bfloat16)
                 for h in (H, KH, KH))


@pytest.mark.parametrize("causal", [True, False])
def test_split_p_stays_inside_the_bf16_gate(causal):
    """(1, 128, 16 q heads on 8 kv heads, hd 128): with P split in two
    bf16 parts every output element is within one bf16 ulp of its own
    magnitude (plus 2^-14) of the plain version."""
    q, k, v = _attention_inputs(3)
    want = ref.attention_ref(q, k, v, causal=causal)
    got = flash_emulated(q, k, v, causal=causal)
    assert bf16_ulps(got, want) <= 1.0


# ------------------------------------------------------- mLSTM 3xTF32 ----
def mlstm_chunk_emulated(q, k, v, log_i, log_f, C, n, m, mm):
    """One chunk of ``models.ssm._mlstm_chunk`` for one (b, h), with the
    four products through ``mm`` as the kernel runs them: q k^T, P v,
    (w_t dh^-1/2 q) C^T and (w_c v)^T k; the n terms, the denominator and
    the gates in f32.  q, k, v (L, dh); C (dh, dh) storing v (x) k."""
    L, dh = q.shape
    b = torch.cumsum(log_f, 0)
    lw = b[:, None] - b[None, :] + log_i[None, :]
    lw = torch.where(torch.ones(L, L, dtype=torch.bool).tril(), lw, -1e30)
    inter = m + b
    mt = torch.maximum(inter, lw.amax(-1))
    w_intra = torch.exp(lw - mt[:, None])
    w_inter = torch.exp(inter - mt)
    sc = dh ** -0.5
    P = mm(q, k.T) * sc * w_intra
    h_num = mm(P, v) + mm(q * (w_inter * sc)[:, None], C.T)
    n_t = w_intra @ k + w_inter[:, None] * n[None, :]
    den = torch.maximum((q * sc * n_t).sum(-1).abs(), torch.exp(-mt))
    bl = b[-1]
    m_new = torch.maximum(m + bl, (log_i + (bl - b)).max())
    w_c = torch.exp(log_i + bl - b - m_new)
    decay = torch.exp(m + bl - m_new)
    C_new = decay * C + mm((w_c[:, None] * v).T, k)
    n_new = decay * n + w_c @ k
    return h_num / den[:, None], C_new, n_new, m_new


def mlstm_errors(S, zero, mm, L=256, dh=512, seed=0):
    """h, C, n, m of the emulated chunks against the plain version, each
    as max |error| over max(1, the plain output's largest magnitude)."""
    rng = np.random.default_rng(seed)
    r = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    q, k, v = r(S, dh), r(S, dh), r(S, dh)
    li = r(S)
    lf = torch.nn.functional.logsigmoid(r(S) + 2.0)
    if zero:
        C, n, m = torch.zeros(dh, dh), torch.zeros(dh), torch.zeros(())
    else:
        C, n, m = r(dh, dh), r(dh), r(1)[0]
    one = lambda x: x[None, None]
    want = ref.mlstm_chunkwise_ref(one(q), one(k), one(v), one(li), one(lf),
                                   one(C), one(n), m.reshape(1, 1), L)
    hs = []
    for c in range(S // L):
        sl = slice(c * L, (c + 1) * L)
        h, C, n, m = mlstm_chunk_emulated(q[sl], k[sl], v[sl], li[sl],
                                          lf[sl], C, n, m, mm)
        hs.append(h)
    got = (torch.cat(hs), C, n, m)
    return [float((g.reshape(w.shape) - w).abs().max())
            / max(1.0, float(w.abs().max())) for g, w in zip(got, want)]


@pytest.mark.parametrize("S,zero", [(512, True), (256, False)])
def test_mlstm_three_tf32_passes_inside_the_gate_one_pass_is_not(S, zero):
    """xlstm-1.3b's shapes (dh 512, chunk 256): the phase-10 dispatch from
    a zero state over two chunks, and a 256-token chunk from a random
    state.  With the four products in 3xTF32 every output is within the
    card's 1e-4 gate (here within 1e-5); with one TF32 pass h and C miss
    it (about 4e-4 here), which is why the kernel takes three."""
    e3 = mlstm_errors(S, zero, matmul_3xtf32)
    e1 = mlstm_errors(S, zero, matmul_1xtf32)
    assert max(e3) <= 1e-5, e3
    assert e1[0] > 1e-4 and e1[1] > 1e-4, e1


# ---------------------------------------------------- paged split-KV ----
def paged_split_emulated(q, kp, vp, slot_pos, table, positions, nsplit, *,
                         window=None, softcap=None):
    """The split-KV kernel's arithmetic: each row's visible virtual pages
    (from the window's first page to the query's) cut into ``nsplit``
    ranges of ceil(pages / nsplit); per range and kv head the online
    softmax state (m, l, acc) in f32 over its visible keys, m = -1e30 and
    l = 0 where it saw none; merged with weights exp(m_s - max m) and
    divided by max(l, 1e-30); the output in q's dtype."""
    B, H, hd = q.shape
    _, P, KH, _ = kp.shape
    M = table.shape[1]
    G = H // KH
    win = 1 << 30 if window is None else window
    out = torch.zeros((B, H, hd))
    for b in range(B):
        qp = int(positions[b])
        first, npages = 0, 0
        if qp >= 0:
            lo = qp - win + 1
            first = lo // P if lo > 0 else 0
            npages = max(0, min(M - 1, qp // P) - first + 1)
        per = -(-npages // nsplit)
        for kh in range(KH):
            qf = q[b, kh * G:(kh + 1) * G].float() * hd ** -0.5
            parts = []
            for sp in range(nsplit):
                p0 = min(npages, sp * per)
                keys = [(int(table[b, first + v]), s)
                        for v in range(p0, min(npages, p0 + per))
                        for s in range(P) if int(table[b, first + v]) >= 0]
                keys = [(ph, s) for ph, s in keys
                        if 0 <= int(slot_pos[ph, s]) <= qp
                        and int(slot_pos[ph, s]) > qp - win]
                if not keys:
                    parts.append((torch.full((G,), -1e30), torch.zeros(G),
                                  torch.zeros(G, hd)))
                    continue
                kk = torch.stack([kp[ph, s, kh] for ph, s in keys]).float()
                vv = torch.stack([vp[ph, s, kh] for ph, s in keys]).float()
                x = qf @ kk.T
                if softcap is not None:
                    x = torch.tanh(x / softcap) * softcap
                mx = x.amax(-1)
                p = torch.exp(x - mx[:, None])
                parts.append((mx, p.sum(-1), p @ vv))
            ms = torch.stack([p[0] for p in parts])
            w = torch.exp(ms - ms.amax(0))
            l = (torch.stack([p[1] for p in parts]) * w).sum(0)
            acc = (torch.stack([p[2] for p in parts]) * w[..., None]).sum(0)
            out[b, kh * G:(kh + 1) * G] = acc / torch.clamp(l, min=1e-30)[:,
                                                                           None]
    return out.to(q.dtype)


def _paged_inputs(dtype, seed=4):
    """Four rows over 4-slot pages, G = 2, hd 32: row 0 long with an
    unmapped page and empty slots, row 1 idle (position -1), row 2 two
    pages (most splits of it empty), row 3 long."""
    B, H, KH, hd, P, M, N = 4, 4, 2, 32, 4, 16, 40
    rng = np.random.default_rng(seed)
    pos = np.array([50, -1, 5, 61], np.int32)
    table = np.full((B, M), -1, np.int32)
    phys = iter(rng.permutation(np.arange(1, N)))
    sp = rng.integers(-1, 64, (N, P)).astype(np.int32)
    sp[0] = -1
    for b in range(B):
        if pos[b] < 0:
            continue
        for v in range(pos[b] // P + 1):
            if b == 0 and v == 3:
                continue                       # unmapped
            table[b, v] = next(phys)
            s = v * P + np.arange(P)
            s[(s > pos[b]) | (rng.uniform(size=P) < 0.2)] = -1
            sp[table[b, v]] = s
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return (f(B, H, hd), f(N, P, KH, hd), f(N, P, KH, hd),
            torch.from_numpy(sp), torch.from_numpy(table),
            torch.from_numpy(pos))


@pytest.mark.parametrize("nsplit", [1, 3, 8])
@pytest.mark.parametrize("window,cap", [(None, None), (23, 4.0)])
def test_split_kv_merge_matches_the_plain_version(nsplit, window, cap):
    """Split into 1, 3 or 8 page ranges (row 2's two pages leave most
    ranges empty) and merged: bf16 within one bf16 ulp of each element
    (plus 2^-14) of the plain version, f32 within 1e-5 (sums in another
    order), and the idle row exactly 0."""
    for dtype in (torch.bfloat16, torch.float32):
        args = _paged_inputs(dtype)
        got = paged_split_emulated(*args, nsplit, window=window,
                                   softcap=cap)
        want = ref.paged_attention_ref(*args, window=window, softcap=cap)
        assert (got[1] == 0).all()
        if dtype == torch.bfloat16:
            assert bf16_ulps(got, want) <= 1.0
        else:
            assert float((got - want).abs().max()) <= 1e-5


def single_p_report(seed=3):
    """Largest error, in bf16 ulps of each element (plus 2^-14), of the
    emulated kernel with one bf16 P and with P split, causal and not."""
    q, k, v = _attention_inputs(seed)
    rows = {}
    for causal in (True, False):
        want = ref.attention_ref(q, k, v, causal=causal)
        for name, sp in (("split", True), ("single", False)):
            got = flash_emulated(q, k, v, causal=causal, split_p=sp)
            err = float((got.float() - want.float()).abs().max())
            rows[(causal, name)] = (bf16_ulps(got, want), err)
    return rows


if __name__ == "__main__":
    for (causal, name), (ulps, err) in single_p_report().items():
        print(f"causal={causal} P {name}: {ulps:.4g} bf16 ulps of the "
              f"largest-error element (gate 1), max |err| {err:.4g}")
