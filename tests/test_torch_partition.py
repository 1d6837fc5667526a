"""The port's abstract model state and partition rules
(``models/transformer.py::init_abstract``, ``launch/steps.py``'s
``input_specs``/``abstract_train_state``/``abstract_cache``,
``dist/partition.py``, ``launch/mesh.py``) against the JAX package for
every arch at its full config, on the reference's production meshes
(16, 16) and (2, 16, 16) as abstract meshes: shapes and dtypes equal,
every spec equal to the reference's ``PartitionSpec`` entry for entry,
and on one device every spec fully replicated."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.dist import partition as JP
from repro.launch import mesh as JM
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.dist import partition as TP
from repro_torch.launch import mesh as TM
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree, path=""):
    """(keystr, leaf) pairs of a port tree in JAX's flatten order and key
    format: dict keys sorted (``['k']``), named-tuple fields (``.f``),
    list items (``[i]``); a plain tuple (a spec) is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flat(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _flat(v, f"{path}[{i}]")]
    return [(path, tree)]


def _jflat(tree):
    return [(jax.tree_util.keystr(k), v) for k, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]]


def _same_specs(mine, theirs):
    m, t = _flat(mine), _jflat(theirs)
    assert [k for k, _ in m] == [k for k, _ in t]
    for (k, a), (_, b) in zip(m, t):
        assert a == tuple(b), (k, a, b)


def _same_shapes(mine, theirs):
    m, t = _flat(mine), _jflat(theirs)
    assert [k for k, _ in m] == [k for k, _ in t]
    for (k, a), (_, b) in zip(m, t):
        assert a.device.type == "meta", k
        assert tuple(a.shape) == tuple(b.shape), k
        assert str(a.dtype).split(".")[-1] == np.dtype(b.dtype).name, k


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    return (TT.init_abstract(get_config(arch)),
            JT.init_abstract(jget_config(arch)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, mesh):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, axes = MESHES[mesh]
    tm, jm = TM.make_mesh(shape, axes), AbstractMesh(shape, axes)
    assert TM.batch_axes(tm) == JM.batch_axes(jm)
    assert TM.num_chips(tm) == int(np.prod(shape))
    tparams, jparams = _abstract(arch)
    _same_shapes(tparams, jparams)
    for fsdp in (False, True):
        for moe in ("contract", "expert"):
            _same_specs(TP.param_specs(tparams, tm, fsdp=fsdp, moe_spec=moe),
                        JP.param_specs(jparams, jm, fsdp=fsdp, moe_spec=moe))
    for name, ishape in INPUT_SHAPES.items():
        tb, jb = TS.input_specs(cfg, ishape), JS.input_specs(jcfg,
                                                             JSHAPES[name])
        _same_shapes(tb, jb)
        _same_specs(TP.batch_specs(tb, tm, batch_axes=TM.batch_axes(tm)),
                    JP.batch_specs(jb, jm, batch_axes=JM.batch_axes(jm)))
    dshape = INPUT_SHAPES["decode_32k"]
    per_layers = (False, True) if cfg.local_global else (False,)
    for per_layer in per_layers:
        tc = TS.abstract_cache(cfg, dshape, per_layer=per_layer)
        jc = JS.abstract_cache(jcfg, JSHAPES["decode_32k"],
                               per_layer=per_layer)
        _same_shapes(tc, jc)
        for layout in ("heads", "batch"):
            for bs in (True, False):
                _same_specs(TP.cache_specs(tc, tm, batch_shardable=bs,
                                           layout=layout),
                            JP.cache_specs(jc, jm, batch_shardable=bs,
                                           layout=layout))


def test_abstract_train_state_and_one_device_replication():
    """The train state's meta tensors (params in ``cfg.dtype``, Adam's
    moments f32, a 0-d int32 step) and, on one device, every param,
    batch and cache spec over axes of size 1 only (full replication); the
    production meshes are the
    reference's."""
    for multi in (False, True):
        tm = TM.make_production_mesh(multi_pod=multi)
        assert (tm.axis_names, tm.axis_sizes) == \
            (MESHES["2x16x16" if multi else "16x16"][1],
             MESHES["2x16x16" if multi else "16x16"][0])
    cfg = get_config("mixtral-8x7b")
    params, opt = TS.abstract_train_state(cfg)
    assert opt.step.dtype == torch.int32 and opt.step.shape == ()
    for p, m in zip(jax.tree.leaves(params), jax.tree.leaves(opt.mu)):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert p.shape == m.shape and m.device.type == "meta"
    one = TM.make_mesh((1, 1), ("data", "model"))
    specs = [TP.param_specs(params, one, fsdp=True),
             TP.batch_specs(TS.input_specs(cfg, INPUT_SHAPES["train_4k"]),
                            one),
             TP.cache_specs(TS.abstract_cache(cfg,
                                              INPUT_SHAPES["decode_32k"]),
                            one)]
    leaves = [s for tree in specs for _, s in _flat(tree)]
    named = [x for s in leaves for a in s if a is not None
             for x in (a if isinstance(a, tuple) else (a,))]
    assert leaves and named and all(one.shape[x] == 1 for x in named)
