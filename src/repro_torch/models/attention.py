"""GQA attention with sliding window, logit softcap, QKV bias and KV caches
(port of ``repro/models/attention.py``).

Execution paths:
  * the fresh-k/v branches (no cache, and a dense-cache prefill) run
    ``ops.flash_attention``, whose causal/window mask is index-based: their
    positions are ``arange(S)`` in every row, as ``_embed_inputs`` builds
    them for every whole-prompt prefill and every no-cache forward.  On a
    CUDA tensor that is the hand-written flash kernel
    (``csrc/flash_attention.cu``), whose gradient is the reference's
    plain route (direct, or blocked past ``chunked_threshold``);
  * a paged decode step (S == 1) runs ``ops.paged_attention``, the paged
    gather-decode kernel on a CUDA tensor (``csrc/paged_decode.cu``);
  * everything else (ring-cache decode, a paged prefill chunk whose
    positions start at an offset) materializes scores in
    ``_direct_attention``, or in the blocked ``_chunked_attention`` past
    ``chunked_threshold``.

Caches (as in the reference):
  * full/ring cache — (B, S_or_W, n_kv, hd) k/v, written at ``pos % W``,
    plus ``slot_pos`` (B, S_or_W) absolute positions (-1 empty);
  * paged cache — a batch-free pool of pages (num_pages, page, n_kv, hd)
    addressed through a per-request page table (B, M): virtual page v of a
    request holds absolute positions ``[v*page, (v+1)*page)``.  Page 0 is
    the trash page: writes from idle rows and unmapped virtual pages land
    there and stay masked (its ``slot_pos`` is only ever written -1).

JAX's functional ``.at[].set`` becomes an in-place ``index_put_`` on the
cache tensors: every cache writer here mutates the cache it is given and
returns it.  Idle rows all write trash page 0 at offset 0; those duplicate
indices are harmless only because that page is never read unmasked.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import apply_rope, init_linear, linear, softcap

NEG_INF = -1e30


class KVCache(NamedTuple):
    """Ring-buffer and linear caches are unified: writes always go to slot
    ``pos % W`` and masking reads absolute positions from ``slot_pos``."""
    k: torch.Tensor          # (B, S_or_W, n_kv, hd)
    v: torch.Tensor
    slot_pos: torch.Tensor   # (B, S_or_W) int32 absolute position (-1 empty)


class PagedKVCache(NamedTuple):
    """A shared physical pool of fixed-size pages plus the absolute position
    each page slot holds.  Requests address it through a page table (B, M)
    owned by the serving engine."""
    k_pages: torch.Tensor    # (num_pages, page, n_kv, hd)
    v_pages: torch.Tensor
    slot_pos: torch.Tensor   # (num_pages, page) int32 (-1 empty)


def init_attention_params(gen: torch.Generator, d_model: int, num_heads: int,
                          num_kv_heads: int, head_dim: int,
                          qkv_bias: bool = False):
    return {
        "wq": init_linear(gen, d_model, num_heads * head_dim, qkv_bias),
        "wk": init_linear(gen, d_model, num_kv_heads * head_dim, qkv_bias),
        "wv": init_linear(gen, d_model, num_kv_heads * head_dim, qkv_bias),
        "wo": init_linear(gen, num_heads * head_dim, d_model, False),
    }


def make_cache(batch: int, seq: int, n_kv: int, head_dim: int,
               window: Optional[int] = None, dtype=torch.float32,
               device="cpu") -> KVCache:
    size = min(seq, window) if window else seq
    return KVCache(
        k=torch.zeros((batch, size, n_kv, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, size, n_kv, head_dim), dtype=dtype,
                      device=device),
        slot_pos=torch.full((batch, size), -1, dtype=torch.int32,
                            device=device))


def make_paged_cache(num_pages: int, page: int, n_kv: int, head_dim: int,
                     dtype=torch.float32, device="cpu") -> PagedKVCache:
    return PagedKVCache(
        k_pages=torch.zeros((num_pages, page, n_kv, head_dim), dtype=dtype,
                            device=device),
        v_pages=torch.zeros((num_pages, page, n_kv, head_dim), dtype=dtype,
                            device=device),
        slot_pos=torch.full((num_pages, page), -1, dtype=torch.int32,
                            device=device))


def paged_write(cache: PagedKVCache, page_table, positions, k, v):
    """Scatter k/v (B, S, KH, hd) at absolute ``positions`` (B, S) into the
    pool through ``page_table`` (B, M), in place.  Negative positions and
    unmapped virtual pages route to the trash page 0 with slot_pos -1.
    Returns ``cache``."""
    P = cache.k_pages.shape[1]
    M = page_table.shape[-1]
    ok = positions >= 0
    safe = torch.where(ok, positions, 0)
    vp = torch.clamp(safe // P, 0, M - 1).long()
    off = (safe % P).long()
    phys = torch.gather(page_table, 1, vp)                   # (B, S)
    ok = ok & (phys >= 0)
    phys = torch.where(ok, phys, 0).long()
    cache.k_pages.index_put_((phys, off), k.to(cache.k_pages.dtype))
    cache.v_pages.index_put_((phys, off), v.to(cache.v_pages.dtype))
    cache.slot_pos.index_put_(
        (phys, off), torch.where(ok, positions, -1).to(torch.int32))
    return cache


def paged_gather(cache: PagedKVCache, page_table):
    """Gather each row's pages into position order: (B, M*page, KH, hd)
    k/v plus (B, M*page) kpos (-1 where the virtual page is unmapped).
    Row j of the gathered view is absolute position j."""
    P = cache.k_pages.shape[1]
    B, M = page_table.shape
    tsafe = torch.clamp(page_table, min=0).long()
    KH, hd = cache.k_pages.shape[2], cache.k_pages.shape[3]
    k = cache.k_pages[tsafe].reshape(B, M * P, KH, hd)
    v = cache.v_pages[tsafe].reshape(B, M * P, KH, hd)
    mapped = torch.repeat_interleave(page_table >= 0, P, dim=1)
    kpos = torch.where(mapped, cache.slot_pos[tsafe].reshape(B, M * P), -1)
    return k, v, kpos


# --------------------------------------------------------------------------
def _mask(qpos, kpos, causal: bool, window):
    """qpos: (..., Sq), kpos: (..., Skv) -> bool (..., Sq, Skv)."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    valid = k >= 0
    if causal:
        valid = valid & (k <= q)
    if window is not None:
        valid = valid & (k > q - window)
    return valid


def _direct_attention(q, k, v, qpos, kpos, causal, window, cap, scale):
    """q: (B,Sq,H,hd)  k/v: (B,Skv,KH,hd).  Scores and the weighted sum
    accumulate in f32 from operands rounded to k's storage type, as the
    reference's ``preferred_element_type=f32`` einsums do."""
    B, Sq, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    qf = (q * scale).to(k.dtype).reshape(B, Sq, KH, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf.float(), k.float())
    scores = softcap(scores, cap)
    m = _mask(qpos, kpos, causal, window)              # (B?,Sq,Skv)
    m = m[:, None, None] if m.ndim == 3 else m[None, None, None]
    scores = torch.where(m, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _chunked_attention(q, k, v, qpos, kpos, causal, window, cap, scale,
                       q_block: int = 512, kv_block: int = 1024):
    """Blocked attention with an online softmax (a Python loop over q and
    kv blocks in place of the reference's ``lax.scan``)."""
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    qb = min(q_block, Sq)
    kb = min(kv_block, Skv)
    qpos = qpos.expand(B, Sq)
    kpos = kpos.expand(B, Skv)
    outs = []
    for i in range(0, Sq, qb):
        qi, qpi = q[:, i:i + qb], qpos[:, i:i + qb]
        n = qi.shape[1]
        qf = (qi * scale).to(k.dtype).reshape(B, n, KH, G, hd).float()
        m = torch.full((B, KH, G, n), NEG_INF, device=q.device)
        l = torch.zeros((B, KH, G, n), device=q.device)
        acc = torch.zeros((B, KH, G, n, hd), device=q.device)
        for j in range(0, Skv, kb):
            ki, vi, kpi = k[:, j:j + kb], v[:, j:j + kb], kpos[:, j:j + kb]
            s = torch.einsum("bqkgd,bskd->bkgqs", qf, ki.float())
            s = softcap(s, cap)
            msk = _mask(qpi, kpi, causal, window)[:, None, None]
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vi.dtype).float(), vi.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, n, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def _route(Sq: int, Skv: int, chunked_threshold: int):
    """The reference's plain route: blocked past ``chunked_threshold``."""
    return _chunked_attention if max(Sq, Skv) > chunked_threshold \
        and Sq > 1 else _direct_attention


# --------------------------------------------------------------------------
def attention(params, x, *, num_heads: int, num_kv_heads: int, head_dim: int,
              positions, causal: bool = True, window: Optional[int] = None,
              attn_cap: Optional[float] = None, rope_theta: float = 10_000.0,
              cache=None, chunked_threshold: int = 4096,
              use_rope: bool = True, page_table=None):
    """Full attention block.  x: (B, S, D); positions: (B, S) or (S,).

    Same contract as the reference: with a ``cache`` and S == 1 a decode
    step writes k/v and attends over the cache; with S > 1 a dense cache is
    filled and the fresh k/v attended; a :class:`PagedKVCache` needs
    ``page_table`` (B, M) and writes through it.  ``window`` is a Python
    int or None.  Without a cache, or with a dense cache and S > 1, the
    fresh k/v are attended by the flash kernel, whose mask is index-based:
    ``positions`` must then be ``0..S-1`` in every row (not checked: that
    would cost a host sync).  Returns (out, cache) — caches are updated in
    place.

    On DTensors (a sharded step) everything between the projections runs
    on each rank's whole heads (``dist/spmd.py::HeadLayout``): the kernel
    gets local tensors, and a dense cache is written through its local
    tensors, which the layout matches.
    """
    from repro_torch.dist import spmd
    B, S, D = x.shape
    if spmd.is_dist(x):
        xf = spmd.features(x)
        q, k, v = (spmd.col(xf, params[n]) for n in ("wq", "wk", "wv"))
    else:
        q, k, v = (linear(params[n], x) for n in ("wq", "wk", "wv"))
    kw = dict(causal=causal, window=window, attn_cap=attn_cap,
              rope_theta=rope_theta, chunked_threshold=chunked_threshold,
              use_rope=use_rope, page_table=page_table, head_dim=head_dim)
    if not spmd.is_dist(q):
        if positions.ndim == 1:
            positions = positions[None].expand(B, S)
        o = _attend(q.reshape(B, S, num_heads, head_dim),
                    k.reshape(B, S, num_kv_heads, head_dim),
                    v.reshape(B, S, num_kv_heads, head_dim), positions,
                    cache, **kw)
        return linear(params["wo"], o.reshape(B, S, -1)), cache
    lay = spmd.HeadLayout(q.device_mesh, B, num_heads, num_kv_heads, cache)
    dm = lay.dmesh
    ql = spmd.local(q, dm, lay.q_placements())
    # a rank that meets only some of the gathered kv heads holds a part of
    # their gradient
    part = ()
    if lay.kv_sel != slice(None):
        part = (lay.mdim,)
        k = spmd.layout(k, lay.kv_source(k.shape[-1]))
        v = spmd.layout(v, lay.kv_source(v.shape[-1]))
    kl = spmd.local(k, dm, lay.kv_placements(), part)
    vl = spmd.local(v, dm, lay.kv_placements(), part)
    if positions.ndim == 1:
        positions = positions[None].expand(B, S)
    pl = spmd.local(positions, dm, lay.batch_placements())
    Bl = ql.shape[0]
    lcache = None if cache is None else type(cache)(
        *[t.to_local() if spmd.is_dist(t) else t for t in cache])
    o = _attend(ql.reshape(Bl, S, lay.Hl, head_dim),
                kl.reshape(Bl, S, -1, head_dim),
                vl.reshape(Bl, S, -1, head_dim), pl, lcache,
                kv_sel=lay.kv_sel, **kw)
    o = spmd.wrap(o.reshape(Bl, S, -1), dm, lay.q_placements(),
                  (B, S, num_heads * head_dim))
    return spmd.row(o, params["wo"]), cache


def _attend(q, k, v, positions, cache, *, head_dim: int, causal: bool,
            window, attn_cap, rope_theta: float, chunked_threshold: int,
            use_rope: bool, page_table, kv_sel=slice(None)):
    """Attention over q (B, S, H, hd) and k/v (B, S, KH, hd) at positions
    (B, S), writing ``cache`` in place; returns (B, S, H, hd).  A cache is
    written with every kv head of k/v, and the query heads meet the kv
    heads ``kv_sel`` of them (a rank's share, ``spmd.HeadLayout``)."""
    B, S, num_heads, _ = q.shape
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = head_dim ** -0.5

    if isinstance(cache, PagedKVCache):
        if page_table is None:
            raise ValueError("paged cache requires a page_table")
        paged_write(cache, page_table, positions, k, v)
        if S == 1:
            from repro_torch.kernels import ops
            o = ops.paged_attention(
                q[:, 0], cache.k_pages, cache.v_pages, cache.slot_pos,
                page_table, positions[:, 0].contiguous(), window=window,
                softcap=attn_cap, scale=scale)
            return o[:, None]
        k_all, v_all, kpos = paged_gather(cache, page_table)
    elif cache is not None and S == 1:
        # decode: write this step's k/v into its ring slot, attend over cache
        W = cache.k.shape[1]
        slots = (positions % W).long()                       # (B,1)
        bidx = torch.arange(B, device=q.device)[:, None]
        cache.k.index_put_((bidx, slots), k.to(cache.k.dtype))
        cache.v.index_put_((bidx, slots), v.to(cache.v.dtype))
        cache.slot_pos.index_put_((bidx, slots), positions.to(torch.int32))
        k_all, v_all, kpos = cache.k, cache.v, cache.slot_pos
    else:
        if cache is not None:
            # prefill: persist only the last W positions (all a ring cache
            # can hold), attend over the fresh in-context k/v
            W = cache.k.shape[1]
            n = min(S, W)
            p_tail = positions[:, -n:]
            slots = (p_tail % W).long()
            bidx = torch.arange(B, device=q.device)[:, None]
            cache.k.index_put_((bidx, slots), k[:, -n:].to(cache.k.dtype))
            cache.v.index_put_((bidx, slots), v[:, -n:].to(cache.v.dtype))
            cache.slot_pos.index_put_((bidx, slots), p_tail.to(torch.int32))
        from repro_torch.kernels import ops
        route = _route(S, S, chunked_threshold)

        def plain(q, k, v):
            pos = torch.arange(S, dtype=torch.int32, device=q.device)[None]
            return route(q, k, v, pos, pos, causal, window, attn_cap, scale)

        if kv_sel != slice(None):
            k, v = k[:, :, kv_sel].contiguous(), v[:, :, kv_sel].contiguous()
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=attn_cap, scale=scale,
                                   plain=plain)

    if kv_sel != slice(None):
        k_all, v_all = k_all[:, :, kv_sel], v_all[:, :, kv_sel]
    return _route(S, k_all.shape[1], chunked_threshold)(
        q, k_all, v_all, positions, kpos, causal, window, attn_cap, scale)
