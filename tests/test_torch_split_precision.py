"""The split arithmetic of the two tensor-core kernels, emulated in plain
torch on the CPU.  These tests pin the design's numerics, the reason for
each split, not the kernels' own: the kernels run only on a CUDA card,
where ``chip_smoke.py`` holds them against their plain versions.  The
emulation differs from the kernels in what does not bear on the split
(``torch.tanh`` and the softmax's own loop).

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
