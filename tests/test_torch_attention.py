"""The port's attention layer (``repro_torch/models/attention.py``) against
the JAX package's on the CPU: the paged cache writers exactly, and every
branch of ``attention`` (no cache, dense prefill, ring decode, paged
prefill chunk, paged decode) to 1e-5 in f32, from the same weights and
inputs made with numpy.  The port's fresh-k/v branches always run the
flash kernel's plain version and its paged decode the gather-decode
kernel's; the reference is held on both of its paged decode routes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch import interop
from repro_torch.models import attention as TA

B, D, H, KH, HD, P, M = 2, 32, 4, 2, 16, 4, 6
KW = dict(num_heads=H, num_kv_heads=KH, head_dim=HD)


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _params():
    jp = JA.init_attention_params(jax.random.key(1), D, H, KH, HD, True)
    return jp, interop.model_params(jax.tree.map(np.asarray, jp))


def _pool(rng, n=16):
    """A random pool (garbage in every page) with a per-row page table of
    distinct physical pages, row 1 with an unmapped tail."""
    kp = rng.normal(size=(n, P, KH, HD)).astype(np.float32)
    vp = rng.normal(size=(n, P, KH, HD)).astype(np.float32)
    sp = np.full((n, P), -1, np.int32)
    table = np.full((B, M), -1, np.int32)
    perm = rng.permutation(np.arange(1, n))
    table[0] = perm[:M]
    table[1, :4] = perm[M:M + 4]
    return kp, vp, sp, table


def _jpaged(kp, vp, sp):
    return JA.PagedKVCache(*map(jnp.asarray, (kp, vp, sp)))


def _tpaged(kp, vp, sp):
    return interop.cache_tree(TA.PagedKVCache(kp, vp, sp))


def test_paged_write_and_gather_exact(rng):
    """Writes at absolute positions (negative ones and positions on
    unmapped pages go to the trash page with slot_pos -1), then the
    gathered position-order view: bit-exact."""
    kp, vp, sp, table = _pool(rng)
    pos = np.array([[0, 5, 9, 23, -1], [2, 3, 15, 17, -1]], np.int32)
    k = rng.normal(size=(B, 5, KH, HD)).astype(np.float32)
    v = rng.normal(size=(B, 5, KH, HD)).astype(np.float32)
    jc = JA.paged_write(_jpaged(kp, vp, sp), jnp.asarray(table),
                        jnp.asarray(pos), jnp.asarray(k), jnp.asarray(v))
    tc = _tpaged(kp, vp, sp)
    out = TA.paged_write(tc, torch.as_tensor(table), torch.as_tensor(pos),
                         torch.as_tensor(k), torch.as_tensor(v))
    assert out is tc
    # the trash page's k/v take whichever duplicate write lands last; it
    # is never read unmasked, so only its slot_pos (-1) must agree
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a)[1:], b.numpy()[1:])
    np.testing.assert_array_equal(tc.slot_pos[0].numpy(), -1)
    for a, b in zip(JA.paged_gather(jc, jnp.asarray(table)),
                    TA.paged_gather(tc, torch.as_tensor(table))):
        a, b = np.asarray(a), b.numpy()
        mapped = np.repeat(table >= 0, P, axis=1)
        np.testing.assert_array_equal(a[mapped], b[mapped])
        if a.ndim == 2:                      # kpos: -1 where unmapped
            np.testing.assert_array_equal(a, b)


def _both(jp, tp, x, pos, rows=slice(None), heads=KW, **kw):
    """Outputs compared on batch ``rows``.  ``paged_kernel`` picks the
    reference's paged decode route only; the port has one.  ``heads``:
    the layer's head counts and head dim."""
    jkw = dict(kw)
    kw.pop("paged_kernel", None)
    for k in ("cache", "page_table"):
        if k in kw and kw[k] is not None:
            jkw[k] = kw[k][0]
            kw[k] = kw[k][1]
    jo, jc = JA.attention(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                          **heads, **jkw)
    to, tc = TA.attention(tp, torch.as_tensor(x), positions=torch.as_tensor(
        pos), **heads, **kw)
    np.testing.assert_allclose(to.numpy()[rows], np.asarray(jo)[rows],
                               atol=1e-5)
    return jc, tc


@pytest.mark.parametrize("window,cap", [(None, None), (5, 2.0)])
@pytest.mark.parametrize("causal", [True, False])
def test_no_cache_and_dense_prefill(rng, window, cap, causal):
    """The fresh-k/v branches (the flash kernel's plain version), causal
    and not, without a cache and filling a dense cache (full depth, and a
    ring of 6 slots that keeps the last 6 positions)."""
    jp, tp = _params()
    S = 11
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    kw = dict(window=window, attn_cap=cap, causal=causal)
    _both(jp, tp, x, pos, **kw)
    for W in (None, 6):
        jcache = JA.make_cache(B, 16, KH, HD, W)
        tcache = TA.make_cache(B, 16, KH, HD, W)
        jc, tc = _both(jp, tp, x, pos, cache=(jcache, tcache), **kw)
        for a, b in zip(jc, tc):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_ring_decode(rng):
    """Dense ring-cache decode steps at positions past the ring's width."""
    jp, tp = _params()
    W = 6
    jc, tc = JA.make_cache(B, 16, KH, HD, W), TA.make_cache(B, 16, KH, HD, W)
    for t in range(9):
        x = rng.normal(size=(B, 1, D)).astype(np.float32)
        pos = np.array([[t], [t + 2]], np.int32)
        jc, tc = _both(jp, tp, x, pos, cache=(jc, tc), window=W)
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("kernel", [False, True])
def test_paged_chunk_then_decode(rng, kernel):
    """A paged prefill chunk at an offset (positions 3..9, through the
    gather), then paged decode steps through the gather-decode kernel's
    plain version, with an idle row at position -1; the reference decodes
    through its Pallas kernel (interpret) when ``kernel``, else through
    its gather, which leaves an all-masked row's output undefined (the
    kernels give 0), so that route is held on the active row only."""
    jp, tp = _params()
    kp, vp, sp, table = _pool(rng)
    jc, tc = _jpaged(kp, vp, sp), _tpaged(kp, vp, sp)
    jt, tt = jnp.asarray(table), torch.as_tensor(table)
    x = rng.normal(size=(B, 7, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10, dtype=np.int32), (B, 7)).copy()
    jc, tc = _both(jp, tp, x, pos, cache=(jc, tc), page_table=(jt, tt),
                   window=6, attn_cap=3.0)
    for t in range(10, 13):
        x = rng.normal(size=(B, 1, D)).astype(np.float32)
        pos = np.array([[t], [-1]], np.int32)
        jc, tc = _both(jp, tp, x, pos, cache=(jc, tc), page_table=(jt, tt),
                       window=6, attn_cap=3.0, paged_kernel=kernel,
                       rows=slice(None) if kernel else slice(0, 1))
    np.testing.assert_array_equal(tc.slot_pos.numpy()[1:],
                                  np.asarray(jc.slot_pos)[1:])


def test_chunked_attention_matches_reference(rng):
    """The blocked online-softmax path (used past ``chunked_threshold``)
    with q and kv blocks smaller than the sequence."""
    S = 21
    q = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, HD)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    kpos = np.broadcast_to(pos, (B, S)).copy()
    kpos[1, 4:7] = -1
    want = JA._chunked_attention(*map(jnp.asarray, (q, k, v, pos, kpos)),
                                 True, 8, 2.0, HD ** -0.5, q_block=8,
                                 kv_block=5)
    got = TA._chunked_attention(*map(torch.as_tensor, (q, k, v, pos, kpos)),
                                True, 8, 2.0, HD ** -0.5, q_block=8,
                                kv_block=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_head_dim_160_prefill_then_paged_decode(rng):
    """stablelm-12b's head dim, 160, at a small width (d 64, 4 q heads on 1
    kv head): a no-cache causal prefill (the flash kernel's plain version),
    then a paged prefill chunk and paged decode steps with an idle row (the
    gather-decode kernel's plain version; the reference through its Pallas
    kernel, interpret), each against the reference to 1e-5."""
    d, hd = 64, 160
    heads = dict(num_heads=4, num_kv_heads=1, head_dim=hd)
    jp = JA.init_attention_params(jax.random.key(2), d, 4, 1, hd, False)
    tp = interop.model_params(jax.tree.map(np.asarray, jp))
    x = rng.normal(size=(B, 9, d)).astype(np.float32)
    _both(jp, tp, x, np.arange(9, dtype=np.int32), heads=heads)
    n = 16
    kp = rng.normal(size=(n, P, 1, hd)).astype(np.float32)
    vp = rng.normal(size=(n, P, 1, hd)).astype(np.float32)
    sp = np.full((n, P), -1, np.int32)
    table = np.full((B, M), -1, np.int32)
    perm = rng.permutation(np.arange(1, n))
    table[0], table[1, :4] = perm[:M], perm[M:M + 4]
    jc, tc = _jpaged(kp, vp, sp), _tpaged(kp, vp, sp)
    pt = (jnp.asarray(table), torch.as_tensor(table))
    x = rng.normal(size=(B, 7, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (B, 7)).copy()
    jc, tc = _both(jp, tp, x, pos, heads=heads, cache=(jc, tc),
                   page_table=pt)
    for t in range(7, 10):
        x = rng.normal(size=(B, 1, d)).astype(np.float32)
        jc, tc = _both(jp, tp, x, np.array([[t], [-1]], np.int32),
                       heads=heads, cache=(jc, tc), page_table=pt,
                       paged_kernel=True)
