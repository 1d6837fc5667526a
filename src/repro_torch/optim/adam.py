"""Adam with global-norm clipping, momentum SGD and the cosine warmup
schedule over dicts of tensors (port of ``repro/optim/adam.py``)."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.utils import (global_norm, tree_flatten, tree_map,
                               tree_unflatten)


class AdamState(NamedTuple):
    step: torch.Tensor     # 0-d int32
    mu: object
    nu: object


def adam_init(params) -> AdamState:
    """Zero moments in f32 beside each param (DTensor params get DTensor
    moments of their placements) and a 0-d int32 step, replicated over
    the params' mesh when they are DTensors."""
    from repro_torch.dist import spmd
    leaf = next(iter(tree_flatten(params)[0]))
    zeros = lambda p: tree_map(lambda x: torch.zeros_like(
        x, dtype=torch.float32), p)
    if spmd.is_dist(leaf):
        from torch.distributed.tensor import Replicate
        dm = leaf.device_mesh
        step = spmd.wrap(torch.zeros((), dtype=torch.int32,
                                     device=leaf.to_local().device), dm,
                         [Replicate()] * dm.ndim, ())
    else:
        step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    return AdamState(step=step, mu=zeros(params), nu=zeros(params))


@torch.no_grad()
def adam_update(grads, state: AdamState, params, *, lr, beta1: float = 0.9,
                beta2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.0, grad_clip: float = 0.0):
    """Returns (new_params, new_state).  ``lr`` may be a scalar or a callable
    of the step.  Clipping scales by ``min(1, clip / max(gn, 1e-12))`` —
    not ``torch.nn.utils.clip_grad_norm_``, whose formula differs."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    if grad_clip:
        gn = global_norm(grads)
        scale = torch.clamp(grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    stepf = step.float()
    b1c = 1.0 - torch.pow(beta1, stepf)
    b2c = 1.0 - torch.pow(beta2, stepf)

    def upd(g, m, v, p):
        g32 = g.float()
        m = beta1 * m + (1 - beta1) * g32
        v = beta2 * v + (1 - beta2) * torch.square(g32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr_t * delta).to(p.dtype), m, v

    flat_p, spec = tree_flatten(params)
    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_flatten(grads)[0], tree_flatten(state.mu)[0],
        tree_flatten(state.nu)[0], flat_p)]
    new_p = tree_unflatten([o[0] for o in out], spec)
    new_m = tree_unflatten([o[1] for o in out], spec)
    new_v = tree_unflatten([o[2] for o in out], spec)
    return new_p, AdamState(step, new_m, new_v)


class SGDState(NamedTuple):
    step: torch.Tensor     # 0-d int32
    mom: object


def sgd_init(params) -> SGDState:
    leaf = next(iter(tree_flatten(params)[0]))
    return SGDState(torch.zeros((), dtype=torch.int32, device=leaf.device),
                    tree_map(lambda x: torch.zeros_like(
                        x, dtype=torch.float32), params))


@torch.no_grad()
def sgd_update(grads, state: SGDState, params, *, lr, momentum: float = 0.9):
    """Heavy-ball SGD: ``m = momentum * m + g``, ``p -= lr * m`` in f32.
    ``lr`` may be a scalar or a callable of the step.  Returns
    (new_params, new_state)."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr

    def upd(g, m, p):
        m = momentum * m + g.float()
        return (p.float() - lr_t * m).to(p.dtype), m

    flat_p, spec = tree_flatten(params)
    out = [upd(g, m, p) for g, m, p in zip(
        tree_flatten(grads)[0], tree_flatten(state.mom)[0], flat_p)]
    return (tree_unflatten([o[0] for o in out], spec),
            SGDState(step, tree_unflatten([o[1] for o in out], spec)))


def cosine_warmup(base_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """Linear warmup over ``warmup`` steps, then a cosine from ``base_lr``
    down to ``floor * base_lr`` at ``total``: a callable of the step (a
    tensor), as ``adam_update`` and ``sgd_update`` take it."""
    def sched(step):
        s = step.float()
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return sched
