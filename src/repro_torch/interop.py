"""Carry weights and state between the JAX package and the port.

The JAX side hands its objects over as numpy trees (for example
``jax.tree.map(np.asarray, state)``); nothing here imports JAX.  Named
tuples and dataclasses are read by field name, so the reference's
``EnvState``, ``AdamState`` and ``MegaConsts`` map onto the port's classes
with the same fields.  :func:`to_numpy` converts the port's objects back
for comparisons.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.envs.base import EnvState, MegaConsts, VectorEnv
from repro_torch.envs.suite import SPECS, build_env
from repro_torch.optim.adam import AdamState, SGDState
from repro_torch.utils import tree_map


def _tensor(x, device):
    return torch.as_tensor(np.array(x, order="C"), device=device)


def policy_params(tree, device="cpu"):
    """Policy params (nested dicts/lists of arrays, ``(in, out)`` weights)."""
    return tree_map(lambda x: _tensor(x, device), tree)


def adam_state(st, device="cpu") -> AdamState:
    return AdamState(step=_tensor(st.step, device).to(torch.int32),
                     mu=policy_params(st.mu, device),
                     nu=policy_params(st.nu, device))


def sgd_state(st, device="cpu") -> SGDState:
    return SGDState(step=_tensor(st.step, device).to(torch.int32),
                    mom=policy_params(st.mom, device))


def env_state(st, device="cpu") -> EnvState:
    f = {k: _tensor(getattr(st, k), device) for k in EnvState._fields}
    for k in ("t", "seed", "resets"):
        f[k] = f[k].to(torch.int32)
    return EnvState(**f)


def mega_consts(mc, device="cpu") -> MegaConsts:
    return MegaConsts(
        sensor=_tensor(mc.sensor, device), tgt=_tensor(mc.tgt, device),
        masses=_tensor(mc.masses, device),
        lengths=_tensor(mc.lengths, device),
        chain=tuple(float(c) for c in mc.chain),
        task=tuple(float(c) for c in mc.task))


def env_like(name: str, mc, megakernel: bool = False,
             device="cpu") -> VectorEnv:
    """The port's env ``name`` built on the reference's constants ``mc``
    (sensor, target, chain geometry), so both packages step the same
    system."""
    return build_env(SPECS[name], mega_consts(mc, device), megakernel)


def experience(exp, device="cpu"):
    """A reference ``Experience`` as the port's, ``actor_version`` as a
    0-d int32 tensor."""
    from repro_torch.rl.a3c import Experience
    f = {k: _tensor(getattr(exp, k), device) for k in Experience._fields}
    f["actor_version"] = f["actor_version"].to(torch.int32)
    return Experience(**f)


def rings(bufs, device="cpu"):
    """Reference ring buffers (a dict keyed by channel) as the port's;
    ``actor_version`` int32."""
    out = {k: _tensor(v, device) for k, v in bufs.items()}
    if "actor_version" in out:
        out["actor_version"] = out["actor_version"].to(torch.int32)
    return out


def model_params(tree, device="cpu", dtype=None):
    """A model's params (the reference ``init_model`` tree as numpy) as the
    port's dict of tensors, same keys and layout (the frontends'
    ``frontend_proj``, ``head`` and ``patch_proj`` included); float leaves
    cast to ``dtype`` when given.  A reference ``AdamState`` or
    ``SGDState`` over such a tree goes through :func:`adam_state` or
    :func:`sgd_state`."""
    def leaf(x):
        t = _tensor(x, device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return tree_map(leaf, tree)


def cache_tree(tree, device="cpu"):
    """A reference cache tree (numpy leaves) as the port's: a stacked
    ``KVCache`` or ``PagedKVCache``, or a patterned stack's dict of those
    and of ``MLSTMState``/``SLSTMState``/``Mamba2State`` nodes.  Nodes are
    matched by class name and read by field name; leaves keep their
    dtypes."""
    from repro_torch.models.attention import KVCache, PagedKVCache
    from repro_torch.models.ssm import Mamba2State, MLSTMState, SLSTMState
    kinds = {c.__name__: c for c in (KVCache, PagedKVCache, MLSTMState,
                                     SLSTMState, Mamba2State)}

    def node(n):
        cls = kinds[type(n).__name__]
        return cls(**{f: _tensor(getattr(n, f), device) for f in cls._fields})
    if isinstance(tree, dict):
        return {k: node(v) for k, v in tree.items()}
    return node(tree)


def to_numpy(obj):
    """Tensors (in any nest of dicts, lists, tuples and named tuples) to
    numpy arrays, keeping the structure."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[to_numpy(x) for x in obj])
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    return obj
