"""Pytree checkpointing: flattened-keypath .npz + JSON manifest, port of
``repro/checkpoint/ckpt.py``.

The file format is the reference's, so a checkpoint written by one package
loads in the other: array ``i`` of the ``.npz`` is ``arr_i``, and the
manifest's ``keys`` list names each array by the key path string
``jax.tree_util.keystr`` gives it, in JAX's flatten order: dict keys
sorted (``['params']``), sequence items by index (``[0]``), named-tuple
fields in field order (``.mu``).  This module builds those strings itself
(:func:`keystr_leaves`), without JAX.  Tensors are saved from the host; a
Python int leaf (``AsyncRunner.version``) is saved as a 0-d int32 and loads
back as a Python int, a Python float as a 0-d float32.

Crash safety (the contract the fault subsystem builds on):

* Writes are atomic and ORDERED: the ``.npz`` is written to a temp file
  and ``os.replace``d into place BEFORE the ``.json`` manifest (itself
  temp+replace).  A crash at any point leaves either the previous pair
  intact or a new ``.npz`` with no manifest — never a manifest pointing at
  a missing or torn array file.
* ``latest_step``/``steps`` skip manifests whose ``.npz`` is absent.
* ``load`` raises a clear error — never returns garbage — on a missing or
  torn (truncated/unreadable) array file, so callers can fall back to the
  previous step (see ``AsyncRunner.restore``).

``fault_hook`` is the deterministic-injection seam used by
``repro_torch.fault``: it is called with a stage name at every durability
boundary and may raise to simulate a crash exactly there.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# stages at which a crash can be injected, in write order
SAVE_STAGES = ("before_npz", "before_npz_replace", "before_manifest",
               "before_manifest_replace")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(fn, tree, path: str = "", is_leaf=None):
    """``tree`` with every leaf ``x`` replaced by ``fn(path, x)``, visiting
    leaves in JAX's flatten order; ``path`` is the leaf's keystr.  ``None``
    is an empty node, as in JAX; ``is_leaf`` marks other nodes as
    leaves."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        out = {k: _map(fn, tree[k], f"{path}[{k!r}]", is_leaf)
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[_map(fn, getattr(tree, f), f"{path}.{f}",
                                 is_leaf) for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x, f"{path}[{i}]", is_leaf)
                          for i, x in enumerate(tree))
    return fn(path, tree)


def keystr_leaves(tree) -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in JAX's flatten order."""
    out: List[Tuple[str, Any]] = []
    _map(lambda p, x: out.append((p, x)), tree)
    return out


def _to_numpy(x) -> np.ndarray:
    from repro_torch.dist import spmd
    if spmd.is_dist(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    return np.asarray(x, np.float32)


def _fire(fault_hook: Optional[Callable[[str], None]], stage: str) -> None:
    if fault_hook is not None:
        fault_hook(stage)


def save(path: str, tree, step: Optional[int] = None,
         extra: Optional[Dict[str, Any]] = None,
         fault_hook: Optional[Callable[[str], None]] = None):
    """Atomically write ``path``.npz (arrays) then ``path``.json
    (manifest).  ``extra`` is a JSON-serializable dict stored in the
    manifest (e.g. controller tables, counters); read it back with
    :func:`load_manifest`.  DTensor leaves are written whole, in the
    reference's format: every rank of their mesh calls ``save`` (the
    gather is a collective) and rank 0 writes."""
    from repro_torch.dist import spmd
    flat = keystr_leaves(tree)
    arrays = {f"arr_{i}": _to_numpy(v) for i, (_, v) in enumerate(flat)}
    if any(spmd.is_dist(v) for _, v in flat) \
            and torch.distributed.get_rank() != 0:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    manifest: Dict[str, Any] = {"keys": [k for k, _ in flat], "step": step}
    if extra is not None:
        manifest["extra"] = extra
    tmp_npz = path + ".tmp.npz"
    tmp_json = path + ".json.tmp"
    _fire(fault_hook, "before_npz")
    np.savez(tmp_npz, **arrays)
    # the array file must be durable BEFORE any manifest names it: a crash
    # between the two replaces leaves an orphan .npz (harmless), never a
    # manifest pointing at a missing/torn array file
    _fire(fault_hook, "before_npz_replace")
    os.replace(tmp_npz, path + ".npz")
    _fire(fault_hook, "before_manifest")
    with open(tmp_json, "w") as f:
        json.dump(manifest, f)
    _fire(fault_hook, "before_manifest_replace")
    os.replace(tmp_json, path + ".json")


def load_manifest(path: str) -> Dict[str, Any]:
    with open(path + ".json") as f:
        return json.load(f)


def load(path: str, like, device="cuda", placements=None, mesh=None):
    """Restore into the structure of ``like`` (a template tree): tensor
    leaves come back as tensors of the template leaf's dtype on ``device``,
    Python int/float leaves as Python numbers.  With ``placements`` (a
    tree like ``like`` of placement tuples, ``partition.to_placements``)
    and the ``DeviceMesh`` ``mesh``, each tensor leaf comes back as a
    DTensor so placed, each rank keeping its shard of the saved array:
    the reference's ``shardings=``.

    Raises ``FileNotFoundError`` when the manifest's array file is absent
    and ``ValueError`` when it is torn/unreadable — callers that keep a
    checkpoint history can fall back to the previous step."""
    manifest = load_manifest(path)
    npz = path + ".npz"
    if not os.path.exists(npz):
        raise FileNotFoundError(
            f"checkpoint {path}: manifest present but array file {npz} "
            "is missing (torn pair)")
    try:
        data = np.load(npz)
    except Exception as e:
        raise ValueError(
            f"checkpoint {path}: array file unreadable (torn write?): "
            f"{e!r}") from e
    by_key = {k: None for k, _ in keystr_leaves(like)}
    with data:
        for i, key in enumerate(manifest["keys"]):
            if key not in by_key:
                raise KeyError(f"checkpoint key {key} not in template")
            try:
                by_key[key] = data[f"arr_{i}"]
            except Exception as e:
                raise ValueError(
                    f"checkpoint {path}: array {i} ({key}) unreadable "
                    f"(torn write?): {e!r}") from e
    missing = [k for k, v in by_key.items() if v is None]
    if missing:
        raise KeyError(f"template keys missing from checkpoint: {missing}")

    placed = {}
    if placements is not None:
        from torch.distributed.tensor import Placement
        _map(lambda k, p: placed.__setitem__(k, p), placements,
             is_leaf=lambda x: isinstance(x, tuple) and bool(x) and all(
                 isinstance(p, Placement) for p in x))

    def leaf(key, tmpl):
        x = by_key[key]
        if isinstance(tmpl, torch.Tensor):
            if key in placed:
                from repro_torch.dist import spmd
                pl = placed[key]
                part = np.ascontiguousarray(
                    x[spmd.local_slices(x.shape, pl, mesh)])
                return spmd.wrap(torch.from_numpy(part).to(
                    device=device, dtype=tmpl.dtype), mesh, pl, x.shape)
            return torch.from_numpy(np.array(x)).to(device=device,
                                                     dtype=tmpl.dtype)
        return type(tmpl)(x)            # a Python int or float
    return _map(leaf, like)


def steps(directory: str) -> List[int]:
    """Checkpoint steps present in ``directory``, ascending.  A manifest
    whose ``.npz`` is absent (torn pair) is skipped — it can never load."""
    found = []
    if not os.path.isdir(directory):
        return []
    for name in os.listdir(directory):
        if name.startswith("ckpt_") and name.endswith(".json"):
            try:
                s = int(name[5:-5])
            except ValueError:
                continue
            if os.path.exists(os.path.join(directory, f"ckpt_{s}.npz")):
                found.append(s)
    return sorted(found)


def latest_step(directory: str) -> Optional[int]:
    all_steps = steps(directory)
    return all_steps[-1] if all_steps else None
