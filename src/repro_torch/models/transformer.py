"""Model assembly: embeddings, the homogeneous attention + MLP stack and
the patterned recurrent stack, their caches, and the prefill / decode
entry points (port of ``repro/models/transformer.py``).

Params keep the reference's layout, including the stacked leading layer
dimension of ``params["layers"]`` and, for a patterned stack (xlstm: 7 x
mLSTM + 1 x sLSTM; zamba2: 8 x Mamba2 + 1 x shared attention), of each
``params["super"]["<kind>_<i>"]`` (leading dim ``num_super``).  zamba2's
``attn_shared`` positions all apply the one block ``params["shared_attn"]``
(attention + MLP), each with a cache of its own.  A mixture-of-experts
stack's layers hold ``lp["moe"]`` (router and expert-stacked weights,
``models/moe.py``) in place of ``lp["mlp"]``.  The reference's
``lax.scan`` over the stack becomes a Python loop that hands each layer
its slice of the stacked params and caches, and the layer writes its
cache slice in place.

A patterned stack's cache is a dict keyed like its params: recurrent states
(``ssm.MLSTMState``, ``ssm.SLSTMState``, ``ssm.Mamba2State``) and the
shared attention's ``KVCache`` or ``PagedKVCache`` nodes, each with a
leading ``num_super`` dim (the batch at axis 1 of a state), kept beside
the page pool by the serving engine.  A dense stack's cache is one
stacked ``KVCache`` or ``PagedKVCache``.  :func:`cache_nodes` lists
either form's nodes.

Runs every family of ``configs.ARCHS``: the dense and mixture-of-experts
stacks, xlstm's mLSTM/sLSTM stack, zamba2's Mamba2 + shared-attention
stack, and the two frontend stubs, as in the reference: audio (hubert)
feeds precomputed frame features through ``frontend_proj`` into an
encoder-only stack read out by ``head``; vision (pixtral) projects patch
embeddings with ``patch_proj`` and puts them ahead of the text tokens.
:func:`loss_fn` is the reference's training loss (causal LM, masked
prediction, text-only next token for the VLM) over
:func:`_chunked_xent`; ``remat`` recomputes each layer (or super-block)
in the backward with ``torch.utils.checkpoint``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models.attention import (KVCache, PagedKVCache, attention,
                                          init_attention_params, make_cache,
                                          make_paged_cache)
from repro_torch.models.layers import (embed, init_embedding, init_linear,
                                       init_mlp, init_rmsnorm, linear, mlp,
                                       rms_norm, softcap, unembed)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.utils import resolve_device, tree_leaves, tree_map

BIG_WINDOW = 1 << 30  # "no window" sentinel, as in the reference

# --------------------------------------------------------------------------
# Activation-sharding hook, as in the reference: when a sharded step sets a
# spec (``launch/steps.py::_act_spec``), the hidden state is redistributed
# to it at every layer (super-block) boundary, so the remat stash is
# sharded instead of replicated over ``model``.  Plain tensors pass.
_ACT_SPEC = None


def set_activation_sharding(spec):
    global _ACT_SPEC
    _ACT_SPEC = spec


@contextlib.contextmanager
def activation_sharding(spec):
    """``set_activation_sharding(spec)`` for the body, the old spec
    after."""
    old = _ACT_SPEC
    set_activation_sharding(spec)
    try:
        yield
    finally:
        set_activation_sharding(old)


def _constrain(x):
    from repro_torch.dist import spmd
    if _ACT_SPEC is not None and x.ndim >= 3:
        x = spmd.constrain(x, _ACT_SPEC)
    return x

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ======================================================================
# init
# ======================================================================
def _init_attn_layer(gen: torch.Generator, cfg: ModelConfig):
    p = {
        "ln1": init_rmsnorm(cfg.d_model, gen.device),
        "attn": init_attention_params(gen, cfg.d_model, cfg.num_heads,
                                      cfg.num_kv_heads, cfg.resolved_head_dim,
                                      cfg.qkv_bias),
        "ln2": init_rmsnorm(cfg.d_model, gen.device),
    }
    if cfg.num_experts:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.num_experts)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act)
    return p


def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig):
    if kind in ("attn", "attn_shared"):
        return _init_attn_layer(gen, cfg)
    if kind == "mlstm":
        return ssm.init_mlstm(gen, cfg.d_model, cfg.num_heads,
                              expansion=cfg.ssm_expansion,
                              conv_width=cfg.conv_width)
    if kind == "slstm":
        return ssm.init_slstm(gen, cfg.d_model, cfg.num_heads)
    if kind == "mamba2":
        return ssm.init_mamba2(gen, cfg.d_model, cfg.ssm_state_dim,
                               conv_width=cfg.conv_width)
    raise ValueError(kind)


def _keys(tree, prefix: tuple = ()):
    """(key path, leaf) of every leaf of a nested dict, in tree order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _keys(v, prefix + (k,))]
    return [(prefix, tree)]


def _cut(tree, prefix: tuple, where):
    """``tree`` with each leaf cut to ``where(key path)`` (a tuple of
    slices), copied so the full leaf can go; itself without ``where``."""
    if where is None:
        return tree
    if isinstance(tree, dict):
        return {k: _cut(v, prefix + (k,), where) for k, v in tree.items()}
    return tree[where(prefix)].clone()


def _init_stacked(make, n: int, prefix: tuple = (), where=None, dt=None):
    """``n`` draws of ``make()`` stacked leaf by leaf.  Each draw is copied
    into the stack as it is made, so the n draws and their stack are never
    all held at once (stablelm-12b's 40 f32 layers are 45 GiB).  With
    ``where`` (key path of the stacked leaf -> its slices, the first over
    the layers) only that part of each leaf is kept."""
    out = None
    for i in range(n):
        one = make()
        if out is None:
            cuts = [where(prefix + k) if where else
                    (slice(0, n),) + tuple(slice(None) for _ in t.shape)
                    for k, t in _keys(one)]
            out = [t.new_empty((c[0].stop - c[0].start,)
                               + tuple(t[c[1:]].shape),
                               dtype=_leaf_dtype(k[-1], t, dt))
                   for (k, t), c in zip(_keys(one), cuts)]
        for dst, (_, src), c in zip(out, _keys(one), cuts):
            if c[0].start <= i < c[0].stop:
                dst[i - c[0].start].copy_(src[c[1:]])
    it = iter(out)
    return tree_map(lambda _: next(it), one)


def init_model(seed: int, cfg: ModelConfig, device="cuda",
               where=None, cast: bool = False) -> Dict[str, Any]:
    """Random f32 params from ``seed`` with the reference's tree layout, on
    the card unless ``device`` says otherwise.  The draws differ from the
    reference's (``jax.random`` is not reproducible here): parity tests
    carry the reference's params across with ``interop.model_params``.
    ``where`` (a leaf's key path -> a tuple of slices) keeps only that part
    of each leaf, drawn in the same order, one layer at a time
    (``dist/partition.py::init_local``).  ``cast`` puts each leaf in the
    type :func:`cast_params` gives it as soon as it is drawn, so no more
    than one layer's draws, or one top-level leaf, is ever held in f32
    (gemma2-27b is 109 GB in f32, 54 GB in bf16); the params are bit for
    bit ``cast_params`` of the f32 ones."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    dt = torch_dtype(cfg) if cast else None

    def top(key, tree):
        return _cast(_cut(tree, (key,), where), dt)

    params: Dict[str, Any] = {
        "final_norm": top("final_norm", init_rmsnorm(cfg.d_model, device))}
    if cfg.frontend == "audio":
        params["frontend_proj"] = top("frontend_proj", init_linear(
            gen, cfg.frontend_feat_dim, cfg.d_model))
        params["head"] = top("head", init_linear(gen, cfg.d_model,
                                                 cfg.vocab_size))
    else:
        params["embed"] = top("embed", init_embedding(gen, cfg.vocab_size,
                                                      cfg.d_model))
        if not cfg.tie_embeddings:
            params["unembed"] = top("unembed", init_linear(
                gen, cfg.d_model, cfg.vocab_size))
    if cfg.frontend == "vision":
        params["patch_proj"] = top("patch_proj", init_linear(
            gen, cfg.frontend_feat_dim, cfg.d_model))
    if cfg.block_pattern:
        params["super"] = {
            f"{kind}_{i}": _init_stacked(
                lambda: _init_block(gen, kind, cfg), cfg.num_super,
                ("super", f"{kind}_{i}"), where, dt)
            for i, kind in enumerate(cfg.block_pattern)
            if kind != "attn_shared"}
        if "attn_shared" in cfg.block_pattern:
            params["shared_attn"] = top("shared_attn",
                                        _init_attn_layer(gen, cfg))
    else:
        params["layers"] = _init_stacked(lambda: _init_attn_layer(gen, cfg),
                                         cfg.num_layers, ("layers",), where,
                                         dt)
    return params


def init_abstract(cfg: ModelConfig) -> Dict[str, Any]:
    """The param tree on ``torch.device("meta")`` in ``cfg.dtype`` (int
    leaves keep theirs): shapes without allocation, traced under a
    ``FakeTensorMode`` so even qwen2-72b costs nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        shapes = init_model(0, cfg, "cpu")
    dt = torch_dtype(cfg)
    return tree_map(lambda t: torch.empty(
        t.shape, dtype=dt if t.is_floating_point() else t.dtype,
        device="meta"), shapes)


# leaves the reference reads in f32 whatever the activation type: the
# RMSNorm scales (``rms_norm`` multiplies in f32), the sLSTM recurrent
# weights ``r`` and Mamba2's per-head ``A_log``, ``D`` and ``dt_bias``
_F32_LEAVES = ("scale", "r", "A_log", "D", "dt_bias")


def cast_params(params, cfg: ModelConfig):
    """Every float leaf except ``_F32_LEAVES`` in ``cfg.dtype``: the matmul
    weights, biases, conv weights, the embedding table, and the MoE
    router and expert weights.  The reference casts these to the
    activation type inside every call; that cast is exact and
    deterministic, so doing it once gives the same numbers without
    re-reading the f32 weights each step."""
    return _cast(params, torch_dtype(cfg))


def _leaf_dtype(key, t, dt):
    """The type of leaf ``t`` under dict key ``key`` cast to ``dt`` (None:
    its own): ``_F32_LEAVES`` and integer leaves keep theirs."""
    if dt is None or key in _F32_LEAVES or not t.is_floating_point():
        return t.dtype
    return dt


def _cast(tree, dt, key=None):
    if isinstance(tree, dict):
        return {k: _cast(v, dt, k) for k, v in tree.items()}
    return tree.to(_leaf_dtype(key, tree, dt))


# ======================================================================
# caches
# ======================================================================
def _stacked(one, n: int):
    return type(one)(*[t[None].repeat((n,) + (1,) * t.ndim) for t in one])


def cache_nodes(caches):
    """A cache tree's nodes in order: the one stacked cache of a dense
    stack, or the values of a patterned stack's dict in key order (the
    order the reference's tree flattens in), so two trees of one model
    pair node for node whatever order their dicts were built in."""
    if isinstance(caches, dict):
        return [caches[k] for k in sorted(caches)]
    return [caches]


def _patterned_cache(cfg: ModelConfig, batch: int, max_seq: int, window,
                     dt, device, paged=None):
    """A patterned stack's nodes, each stacked over ``num_super``: the
    recurrent states (f32 except the conv state, which is in the
    activation type) and, at ``attn_shared`` positions, a dense
    ``KVCache`` of ``window`` (None: full depth), or with ``paged``
    ``(page_size, num_pages)`` a batch-free paged pool."""
    di_mlstm = cfg.d_model * cfg.ssm_expansion
    di = cfg.d_model * 2                      # mamba2 expansion fixed at 2
    H = cfg.num_heads
    hd = cfg.resolved_head_dim
    caches = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "mlstm":
            one = ssm.mlstm_init_state(batch, H, di_mlstm // H, di_mlstm,
                                       cfg.conv_width, dt, device)
        elif kind == "slstm":
            one = ssm.slstm_init_state(batch, H, cfg.d_model // H, device)
        elif kind == "mamba2":
            one = ssm.mamba2_init_state(batch, di, cfg.ssm_state_dim, 64,
                                        cfg.conv_width, dt, device)
        elif paged is not None:
            one = make_paged_cache(paged[1], paged[0], cfg.num_kv_heads, hd,
                                   dt, device)
        else:
            one = make_cache(batch, max_seq, cfg.num_kv_heads, hd, window,
                             dt, device)
        caches[f"{kind}_{i}"] = _stacked(one, cfg.num_super)
    return caches


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               window_override: Optional[int] = None, dtype=None,
               device="cpu", per_layer: bool = False):
    """Stacked per-layer dense caches for decode (leading dim = layers), or
    a patterned stack's dict of recurrent states.  ``per_layer=True``
    (local/global archs) gives a list of per-layer caches, each sized to
    its own window: gemma2's local layers then hold a ring of their
    window instead of the full context."""
    dt = dtype or torch_dtype(cfg)
    if cfg.block_pattern:
        return _patterned_cache(cfg, batch, max_seq,
                                window_override or cfg.sliding_window, dt,
                                device)
    hd = cfg.resolved_head_dim

    def attn_cache(window):
        return make_cache(batch, max_seq, cfg.num_kv_heads, hd, window, dt,
                          device)

    windows = layer_windows(cfg, window_override)
    if per_layer:
        return [attn_cache(None if w == BIG_WINDOW else w) for w in windows]
    # uniform, or mixed local/global: every cache sized to the largest
    # window; local layers still mask to their own
    maxw = max(windows)
    return _stacked(attn_cache(None if maxw == BIG_WINDOW else maxw),
                    cfg.num_layers)


def init_paged_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     window_override: Optional[int] = None, dtype=None, *,
                     page_size: int, num_pages: int, device="cpu"):
    """Paged variant of :func:`init_cache`: one batch-free
    :class:`PagedKVCache` pool per attention layer, stacked (page 0 =
    trash); a patterned stack's attention nodes (zamba2's) are pools
    stacked over ``num_super``.  Pages hold absolute positions at full
    depth; sliding windows apply purely through masking.  Recurrent
    states are fixed-size per slot and stay batched exactly as in
    :func:`init_cache`; xlstm has no attention node, so its tree holds no
    pool at all."""
    dt = dtype or torch_dtype(cfg)
    if cfg.block_pattern:
        return _patterned_cache(cfg, batch, max_seq, None, dt, device,
                                paged=(page_size, num_pages))
    one = make_paged_cache(num_pages, page_size, cfg.num_kv_heads,
                           cfg.resolved_head_dim, dt, device)
    return _stacked(one, cfg.num_layers)


def layer_windows(cfg: ModelConfig, window_override: Optional[int] = None):
    """Static per-layer attention window list (BIG_WINDOW = unlimited);
    for a patterned stack, one entry an ``attn_shared`` application."""
    if cfg.block_pattern:
        n = sum(1 for k in cfg.layer_kinds if k == "attn_shared")
        return [window_override or cfg.sliding_window or BIG_WINDOW] * n
    out = []
    for i in range(cfg.num_layers):
        if cfg.local_global:
            # even layers local (sliding window), odd layers global
            if i % 2 == 0:
                out.append(cfg.sliding_window or BIG_WINDOW)
            else:
                out.append(window_override or BIG_WINDOW)
        elif cfg.sliding_window:
            out.append(cfg.sliding_window)
        else:
            out.append(window_override or BIG_WINDOW)
    return out


# ======================================================================
# blocks
# ======================================================================
def _attn_block(lp, x, cfg: ModelConfig, positions, window, cache,
                page_table=None):
    """Attention and MLP (or MoE) block; returns (x, cache, aux), aux the
    MoE layer's load-balance loss or None."""
    h = rms_norm(lp["ln1"], x, cfg.norm_eps)
    a, cache = attention(
        lp["attn"], h, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions, causal=cfg.causal,
        window=window, attn_cap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
        cache=cache, page_table=page_table)
    # a sharded step reduces each branch's partial sums straight into the
    # residual stream's placement
    x = x + _like(a, x)
    h = rms_norm(lp["ln2"], x, cfg.norm_eps)
    if "moe" in lp:
        m, aux = moe_apply(
            lp["moe"], h, num_experts=cfg.num_experts,
            top_k=cfg.experts_per_token, aux_coef=cfg.router_aux_coef,
            capacity_factor=cfg.moe_capacity_factor,
            route_block=cfg.moe_route_block)
        return x + _like(m, x), cache, aux
    return x + _like(mlp(lp["mlp"], h, cfg.act), x), cache, None


class _Layers:
    """``n`` layers made on demand by ``get(i)``."""

    def __init__(self, get, n: int):
        self.get, self.n = get, n

    def __getitem__(self, i):
        return self.get(i)

    def __len__(self):
        return self.n


def _like(a, x):
    """DTensor ``a`` in ``x``'s placements (its partial sums reduced
    there); a plain tensor as it is."""
    from repro_torch.dist import spmd
    return spmd.layout(a, x.placements) if spmd.is_dist(a) else a


def _unstack(tree, n: int):
    """The ``n`` per-layer views of a stacked tree (leading dim ``n``), by
    one ``unbind`` a leaf.  Its backward stacks a leaf's layer gradients
    once; indexing layer by layer would instead add a zero-padded,
    full-size gradient of the stacked leaf for every layer (quadratic in
    depth).  A DTensor leaf whose layer dim is split (FSDP on the layer
    dim) gives each layer when it is read, gathered from the rank holding
    it (``spmd.stack_layer``), so no rank holds the whole stack."""
    from repro_torch.dist import spmd
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return _Layers(lambda i: {k: per[k][i] for k in tree}, n)
    if spmd.is_dist(tree) and spmd.sharded_dims(tree, 0):
        return _Layers(lambda i: spmd.stack_layer(tree, i), n)
    return torch.unbind(tree, 0)


def _freeze_idle(old, new, positions):
    """Write ``new`` into the state ``old`` in place, except for decode rows
    at negative positions, whose state stays pinned.

    A paged engine parks idle and still-prefilling slots at position -1;
    without this every batched decode step would advance (corrupt) the
    state a chunked prefill is building in that row.  Dense engines park
    idle rows at position 0, which keeps their advance-and-overwrite
    behavior, as in the reference."""
    keep = positions[:, 0] >= 0
    for o, n in zip(old, new):
        o.copy_(torch.where(keep.reshape((-1,) + (1,) * (n.ndim - 1)), n, o))


def _model_split(kind, lp, cfg: ModelConfig, cache, dmesh) -> tuple:
    """(split, state dims, cuts) of a recurrent block on ``dmesh``: the
    number of ``model`` ranks its work splits over (1: whole on every
    rank), for each leaf of its state the dim that split cuts (None for
    none), and the ``spmd.Cut`` of each weight but ``norm`` (``ssm``'s
    ``*_cuts``).  With a state, each block runs on the split
    ``partition.cache_specs`` gives it: Mamba2 on ``h``'s head dim p, the
    mLSTM on ``C``'s value rows, the sLSTM's recurrence on its heads where
    the cache splits them (its projections split wherever ``d_model``
    divides ``model``).  With none, Mamba2 on its heads and the mLSTM on
    its value rows where they divide ``model``."""
    from repro_torch.dist import spmd
    m = spmd.axis_size(dmesh, "model")
    if m == 1:
        return 1, None, None
    mdim = list(dmesh.mesh_dim_names).index("model")
    di = cfg.d_model * cfg.ssm_expansion

    def cut(t, d):
        return mdim in spmd.sharded_dims(t, d)
    if kind == "mamba2":
        hd = lp["gnorm"]["scale"].shape[0] // lp["A_log"].shape[0]
        if cache is None and lp["A_log"].shape[0] % m == 0:
            return m, None, ssm.mamba2_cuts(m, di, cfg.ssm_state_dim, hd,
                                            False)
        if cache is not None and cut(cache.h, 2):
            return m, (2, None), ssm.mamba2_cuts(m, di, cfg.ssm_state_dim,
                                                 hd, True)
        return 1, None, None
    if kind == "mlstm":
        if (cut(cache.C, 2) if cache is not None
                else (di // cfg.num_heads) % m == 0):
            dims = None if cache is None else (2, None, None, None)
            return m, dims, ssm.mlstm_cuts(m, cfg.num_heads, di)
        return 1, None, None
    if cfg.d_model % m:
        return 1, None, None
    heads = cut(cache.c, 1) if cache is not None else cfg.num_heads % m == 0
    return m, (1, 1, 1, 1) if cache is not None and heads else None, \
        ssm.slstm_cuts(m, cfg.num_heads, cfg.d_model, heads)


def _apply_kind(kind, lp, x, cfg: ModelConfig, positions, cache,
                region=None):
    """One recurrent block; a given state is updated in place.  A decode
    step (S == 1 with a cache) takes the exact recurrent update and pins
    idle rows; everything else takes the chunkwise form, whose mLSTM part
    is one ``ops.mlstm_chunkwise`` call, with the reference's chunk of
    ``min(256, S)``.  On DTensors the block runs on each rank's batch rows
    (``spmd.local_region``) and, where :func:`_model_split` splits it, on
    the rank's share over ``model`` (``region``), its state cut there in
    place: Mamba2 on its heads or its head dim, the mLSTM on its value
    rows, the sLSTM with its projections split."""
    from repro_torch.dist import spmd
    if spmd.is_dist(x):
        dm = x.device_mesh
        bd = spmd.sharded_dims(cache[0], 0) if cache is not None \
            else spmd.batch_dims(dm, x.shape[0])
        split, state_dims, cuts = _model_split(kind, lp, cfg, cache, dm)
        shared = {k: v for k, v in lp.items() if k != "norm"} \
            if split > 1 else {}
        own = {k: v for k, v in lp.items() if k not in shared}
        pos_b = positions.ndim == 2
        batched = [x, positions] if pos_b else [x]
        whole = [own] if pos_b else [own, positions]

        def body(region, *a):
            if pos_b:
                xl, pl, lpl, spl, st = a
            else:
                xl, lpl, pl, spl, st = a
            return _apply_kind(kind, {**lpl, **spl}, xl, cfg, pl, st,
                               region if split > 1 else None)
        return spmd.local_region(body, dm, bd, batched, whole, [cache],
                                 [shared], split, [state_dims], [cuts])
    decode = x.shape[1] == 1 and cache is not None
    if kind == "mlstm" and decode:
        y, st = ssm.mlstm_decode_step(lp, x, cache, num_heads=cfg.num_heads,
                                      expansion=cfg.ssm_expansion,
                                      region=region)
    elif kind == "mlstm":
        y, st = ssm.mlstm_apply(lp, x, num_heads=cfg.num_heads, state=cache,
                                chunk=min(256, x.shape[1]),
                                expansion=cfg.ssm_expansion, region=region)
    elif kind == "mamba2" and decode:
        y, st = ssm.mamba2_decode_step(lp, x, cache,
                                       state_dim=cfg.ssm_state_dim,
                                       region=region)
    elif kind == "mamba2":
        y, st = ssm.mamba2_apply(lp, x, state_dim=cfg.ssm_state_dim,
                                 state=cache, chunk=min(256, x.shape[1]),
                                 region=region)
    elif kind == "slstm":
        y, st = ssm.slstm_apply(lp, x, num_heads=cfg.num_heads, state=cache,
                                region=region)
    else:
        raise ValueError(kind)
    if decode:
        _freeze_idle(cache, st, positions)
    elif cache is not None:
        for o, n in zip(cache, st):
            o.copy_(n)
    return y


def _zero(x):
    """A 0-d f32 zero like ``x``: on its device, replicated over its mesh
    when ``x`` is a DTensor."""
    from repro_torch.dist import spmd
    if not spmd.is_dist(x):
        return torch.zeros((), device=x.device)
    from torch.distributed.tensor import Replicate
    dm = x.device_mesh
    return spmd.wrap(torch.zeros((), device=x.to_local().device), dm,
                     [Replicate()] * dm.ndim, ())


def _remat(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward (the reference's
    ``jax.checkpoint`` of its scan body) when ``remat`` is set and grad is
    enabled."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _apply_patterned(params, cfg: ModelConfig, x, positions, caches=None,
                     window_override: Optional[int] = None, page_table=None,
                     remat: bool = False):
    """The reference's scan over super-blocks with the pattern unrolled
    inside, as a Python loop; each block's state or cache slice is written
    back in place.  Attention positions (zamba2's ``attn_shared``) apply
    ``params["shared_attn"]`` with their own cache, window and the page
    table.  ``remat`` recomputes each super-block in the backward.
    Returns (x, caches, aux)."""
    w_attn = window_override or cfg.sliding_window or BIG_WINDOW
    sup = {k: _unstack(v, cfg.num_super) for k, v in params["super"].items()}

    def super_block(s, x, aux):
        x = _constrain(x)
        for i, kind in enumerate(cfg.block_pattern):
            key = f"{kind}_{i}"
            cache = None if caches is None else type(caches[key])(
                *[t[s] for t in caches[key]])
            if kind in ("attn", "attn_shared"):
                lp = params["shared_attn"] if kind == "attn_shared" \
                    else sup[key][s]
                x, _, a = _attn_block(lp, x, cfg, positions, w_attn, cache,
                                      page_table)
                if a is not None:
                    aux = aux + a
            else:
                x = _apply_kind(kind, sup[key][s], x, cfg, positions,
                                cache)
        return x, aux

    aux = _zero(x)
    for s in range(cfg.num_super):
        x, aux = _remat(super_block, remat and caches is None, s, x, aux)
    return x, caches, aux


def apply_stack(params, cfg: ModelConfig, x, positions, caches=None,
                window_override: Optional[int] = None, page_table=None,
                remat: bool = False):
    """Run the whole layer stack; returns (x, caches, aux), aux the MoE
    load-balance loss summed over layers (f32, 0 without experts).  A
    stacked cache (leading dim = layers) is written in place through
    per-layer views; a list of per-layer caches (``init_cache(...,
    per_layer=True)``) layer by layer.  ``page_table`` (B, M) addresses
    every paged layer: they share one physical page-id space.  ``remat``
    (no caches) recomputes each layer in the backward."""
    if cfg.block_pattern:
        return _apply_patterned(params, cfg, x, positions, caches,
                                window_override, page_table, remat)
    windows = layer_windows(cfg, window_override)
    layers = _unstack(params["layers"], cfg.num_layers)

    def layer(i, x, aux):
        x = _constrain(x)
        if isinstance(caches, list):
            ci = caches[i]
        else:
            ci = None if caches is None else type(caches)(
                *[t[i] for t in caches])
        x, _, a = _attn_block(layers[i], x, cfg, positions, windows[i], ci,
                              page_table)
        return x, aux if a is None else aux + a

    aux = _zero(x)
    for i in range(cfg.num_layers):
        x, aux = _remat(layer, remat and caches is None, i, x, aux)
    return x, caches, aux


# ======================================================================
# model entry points
# ======================================================================
def _embed_inputs(params, cfg: ModelConfig, batch):
    """batch dict -> (x (B,S,D), positions (S,), text_mask (S,) bool or
    None).  Audio: features through ``frontend_proj``; vision with
    ``patches``: the projected patches ahead of the text embeddings, with
    the mask of the text positions."""
    if cfg.frontend == "audio":
        x = linear(params["frontend_proj"], batch["features"])
        return x, _arange(x), None
    if cfg.frontend == "vision" and "patches" in batch:
        pe = linear(params["patch_proj"], batch["patches"])
        te = embed(params["embed"], batch["tokens"])
        x = torch.cat([pe.to(te.dtype), te], dim=1)
        P, Tt = pe.shape[1], te.shape[1]
        text_mask = torch.cat([
            torch.zeros((P,), dtype=torch.bool, device=x.device),
            torch.ones((Tt,), dtype=torch.bool, device=x.device)])
        return x, _arange(x), text_mask
    x = embed(params["embed"], batch["tokens"])
    return x, _arange(x), None


def _arange(x):
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def _logits(params, cfg: ModelConfig, h):
    from repro_torch.dist import spmd
    if spmd.is_dist(h):
        # vocab-parallel: whole features in, the vocab split as the
        # table's is
        if cfg.frontend == "audio":
            lg = spmd.col(h, params["head"])
        elif cfg.tie_embeddings:
            lg = spmd.col(h, {"w": params["embed"]["table"].T})
        else:
            lg = spmd.col(h, params["unembed"])
    elif cfg.frontend == "audio":
        lg = linear(params["head"], h)
    elif cfg.tie_embeddings:
        lg = unembed(params["embed"], h)
    else:
        lg = linear(params["unembed"], h)
    return softcap(lg, cfg.final_softcap)


def forward(params, cfg: ModelConfig, batch, *, remat: bool = False,
            window_override: Optional[int] = None):
    """Full forward pass -> (logits (B,S,V), aux), aux the MoE load-balance
    loss summed over layers (0 for the other families)."""
    x, positions, _ = _embed_inputs(params, cfg, batch)
    x = x.to(torch_dtype(cfg))
    h, _, aux = apply_stack(params, cfg, x, positions,
                            window_override=window_override, remat=remat)
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h), aux


def _xent_chunk(params, cfg: ModelConfig, h, labels, mask):
    """Summed masked NLL of one chunk, in f32."""
    from repro_torch.dist import spmd
    logits = _logits(params, cfg, h).float()
    if spmd.is_dist(logits):
        lse, picked = spmd.vocab_xent(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum((lse - picked) * mask)


def _chunked_xent(h, cfg: ModelConfig, params, labels, mask,
                  chunk: int = 512):
    """Cross-entropy over sequence chunks of ``min(chunk, S)`` positions
    (the sequence padded to a whole number of chunks, padding masked), so
    no (B, S, V) logits tensor exists at once: with grad enabled each
    chunk's logits are recomputed in the backward rather than kept.  On
    DTensors each chunk's logits stay split over the vocab
    (``spmd.vocab_xent``)."""
    from repro_torch.dist import spmd
    B, S, D = h.shape
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    hp = spmd.pad(h, (0, 0, 0, pad))
    lp = spmd.pad(labels, (0, pad))
    mp = spmd.pad(mask, (0, pad))
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        tot = tot + _remat(lambda hc, lc, mc: _xent_chunk(params, cfg, hc,
                                                          lc, mc),
                           True, hp[:, sl], lp[:, sl], mp[:, sl])
        cnt = cnt + torch.sum(mp[:, sl])
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = True,
            window_override: Optional[int] = None):
    """Training loss (causal LM / masked prediction / text-only VLM), plus
    the MoE load-balance loss."""
    from repro_torch.dist import spmd
    x, positions, text_mask = _embed_inputs(params, cfg, batch)
    x = x.to(torch_dtype(cfg))
    h, _, aux = apply_stack(params, cfg, x, positions,
                            window_override=window_override, remat=remat)
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    B, S, _ = h.shape

    if cfg.frontend == "audio":
        loss = _chunked_xent(h, cfg, params, batch["targets"],
                             batch["mask"].float())
        return loss + aux

    if cfg.frontend == "vision" and "patches" in batch:
        T = batch["tokens"].shape[1]
        labels = spmd.pad(batch["labels"], (S - T, 0))
        mask = text_mask[None].expand(B, S).float()
        if spmd.is_dist(h):
            mask = spmd.wrap(mask, h.device_mesh, spmd.placements(
                h.device_mesh, {}), (B, S))
        # next-token: positions predicting text tokens only
        loss = _chunked_xent(h[:, :-1], cfg, params, labels[:, 1:],
                             mask[:, 1:])
        return loss + aux

    labels = batch["labels"]
    mask = torch.ones_like(labels, dtype=torch.float32)
    loss = _chunked_xent(h[:, :-1], cfg, params, labels[:, 1:], mask[:, 1:])
    return loss + aux


def prefill(params, cfg: ModelConfig, batch, max_seq: int,
            window_override: Optional[int] = None,
            per_layer_cache: bool = False, caches=None):
    """Prefill -> (last-position logits, filled caches).  Positions are
    ``arange(S)`` by construction, so every layer's attention runs the
    flash kernel on a CUDA tensor, and every mLSTM block one launch of the
    mLSTM kernel from a zero state.  ``per_layer_cache`` fills a list of
    per-layer caches (local/global archs).  ``caches`` (fresh, as
    ``init_cache`` makes them; a sharded step's are DTensors) are filled
    in place of new ones."""
    x, positions, _ = _embed_inputs(params, cfg, batch)
    x = x.to(torch_dtype(cfg))
    if caches is None:
        caches = init_cache(cfg, x.shape[0], max_seq, window_override,
                            torch_dtype(cfg), device=x.device,
                            per_layer=per_layer_cache)
    h, caches, _ = apply_stack(params, cfg, x, positions, caches=caches,
                               window_override=window_override)
    h = rms_norm(params["final_norm"], h[:, -1:], cfg.norm_eps)
    return _logits(params, cfg, h)[:, 0], caches


def decode_step(params, cfg: ModelConfig, token, pos, caches,
                window_override: Optional[int] = None, page_table=None):
    """One decode step.  token: (B,) int32; pos: (B,) int32 absolute.
    ``page_table`` (B, M) is required when the caches are paged.  The
    stack runs layer by layer, so a list of per-layer caches (the
    reference's ``unroll=True`` layout) is taken as it comes.  Returns
    (logits (B,V), caches)."""
    if cfg.frontend == "audio":
        raise ValueError("encoder-only model has no decode step")
    x = embed(params["embed"], token[:, None]).to(torch_dtype(cfg))
    h, caches, _ = apply_stack(params, cfg, x, pos[:, None], caches=caches,
                               window_override=window_override,
                               page_table=page_table)
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h)[:, 0], caches


def prefill_chunk(params, cfg: ModelConfig, tokens, positions, caches, slot,
                  page_table, window_override: Optional[int] = None):
    """One B=1 prefill chunk for decode slot ``slot`` (a Python int) against
    the engine's batched cache tree: recurrent-state leaves are viewed at
    the slot (batch axis 1) and updated in place through the view, paged
    attention nodes are batch-free and written in place through
    ``page_table`` (M,), so a chunk never touches other slots' state or
    pages.  tokens/positions: (C,) int32, absolute (chunk k >= 1 of a
    prompt starts at its offset).  Returns (last-position logits (1, V),
    caches)."""
    if not cfg.block_pattern and not isinstance(caches, PagedKVCache):
        raise ValueError("prefill_chunk needs the paged cache pool")

    def view(node):
        if isinstance(node, PagedKVCache):
            return node
        return type(node)(*[t[:, slot:slot + 1] for t in node])

    views = {k: view(n) for k, n in caches.items()} \
        if isinstance(caches, dict) else view(caches)
    x = embed(params["embed"], tokens[None]).to(torch_dtype(cfg))
    h, _, _ = apply_stack(params, cfg, x, positions[None], caches=views,
                          window_override=window_override,
                          page_table=page_table[None])
    h = rms_norm(params["final_norm"], h[:, -1:], cfg.norm_eps)
    return _logits(params, cfg, h)[:, 0], caches

