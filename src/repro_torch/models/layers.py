"""Core NN layers: RMSNorm, RoPE, embeddings, MLPs (port of
``repro/models/layers.py``).

Params are plain nested dicts of tensors with the reference's keys and
``(in, out)`` weight layout; every layer is an ``init_*(gen, ...) ->
params`` / ``apply(params, x, ...)`` pair.  ``linear``, ``mlp`` and
``unembed`` cast the weight to ``x.dtype`` in every call, as the reference
does; the cast is a no-op when the weights already hold that type, which
is why the serving engine casts them once up front
(``transformer.cast_params``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils import lecun_init


# ---------------------------------------------------------------- norms ----
def init_rmsnorm(d: int, device="cpu"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(params, x, eps: float = 1e-6):
    from repro_torch.dist import spmd
    if spmd.is_dist(x) and spmd.sharded_dims(x, x.ndim - 1):
        return spmd.rms_norm_split(params["scale"], x, eps)
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(dt)


def init_layernorm(d: int, device="cpu"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layer_norm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


# ----------------------------------------------------------------- rope ----
def rope_freqs(head_dim: int, theta: float, device="cpu"):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * inv              # (..., seq, hd/2)
    sin = torch.sin(ang)[..., None, :]                    # over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ softcap ------
def softcap(x, cap):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ------------------------------------------------------------ linear -------
def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = False):
    p = {"w": lecun_init(gen, (d_in, d_out))}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
    return p


def linear(params, x):
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------- mlp ------
def init_mlp(gen: torch.Generator, d: int, d_ff: int, act: str = "silu"):
    if act in ("silu", "swiglu"):
        return {"wi": lecun_init(gen, (d, d_ff)),
                "wg": lecun_init(gen, (d, d_ff)),
                "wo": lecun_init(gen, (d_ff, d))}
    return {"wi": lecun_init(gen, (d, d_ff)),
            "wo": lecun_init(gen, (d_ff, d))}


def mlp(params, x, act: str = "silu"):
    """On DTensors the input products are column-parallel and the output
    product row-parallel (``dist/spmd.py``): the result is then a partial
    sum over ``model`` for the caller to reduce."""
    from repro_torch.dist import spmd
    dt = x.dtype
    if spmd.is_dist(x):
        x = spmd.features(x)
        h = spmd.col(x, {"w": params["wi"]})
        g = spmd.col(x, {"w": params["wg"]}) if "wg" in params else None
    else:
        h = x @ params["wi"].to(dt)
        g = x @ params["wg"].to(dt) if "wg" in params else None
    if g is not None:
        h = F.silu(g) * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    else:
        h = F.silu(h)
    if spmd.is_dist(h):
        return spmd.row(h, {"w": params["wo"]})
    return h @ params["wo"].to(dt)


# ------------------------------------------------------- embeddings --------
def init_embedding(gen: torch.Generator, vocab: int, d: int):
    return {"table": torch.randn((vocab, d), generator=gen, device=gen.device,
                                 dtype=torch.float32) * 0.02}


def embed(params, tokens):
    """Rows of the table.  A DTensor table (vocab-parallel over
    ``model``) is read on each rank's tokens: each rank looks up the rows
    it holds, zeros elsewhere, and the rows are summed over ``model``."""
    from repro_torch.dist import spmd
    if not spmd.is_dist(params["table"]):
        return params["table"][tokens]
    return spmd.vocab_lookup(params["table"], tokens)


def unembed(params, x):
    return x @ params["table"].T.to(x.dtype)
