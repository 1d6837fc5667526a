"""Parity of the port's checkpoint module with the JAX package on the CPU:
one file format, so a checkpoint written by either package loads in the
other bit for bit with the same manifest ``keys``; the crash-safety cases
of ``tests/test_checkpoint.py`` (a crash at every save stage, torn and
missing array files, template mismatches); and ``AsyncRunner.checkpoint``
/ ``restore`` across the two packages, torn pairs skipped.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.envs import make_env as jax_make_env
from repro.rl import a3c as ja3c
from repro_torch import fault as tfault
from repro_torch import interop
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core.controller import OnlineGMIController, RoundSample
from repro_torch.rl import a3c as ta3c


def _runner_tree():
    """A runner's checkpoint template, reference side: params, Adam state
    (a NamedTuple) and a 0-d int32 version."""
    from repro.models.policy import init_policy
    from repro.optim import adam_init
    params = init_policy(jax.random.key(2), (6, 16, 16, 3))
    opt = adam_init(params)
    opt = opt._replace(step=jnp.int32(5),
                       mu=jax.tree.map(lambda x: x + 0.25, opt.mu))
    return {"params": params, "opt_state": opt, "version": jnp.int32(7)}


def _generic_tree():
    key = jax.random.key(0)
    return {"a": {"w": jax.random.normal(key, (4, 3)),
                  "b": jnp.arange(5, dtype=jnp.int32)},
            "scale": jnp.float32(2.5),
            "layers": [{"k": jnp.ones((2,), jnp.float32)},
                       {"k": jnp.full((2,), 3, jnp.int32)}]}


def _to_port(tree):
    """A reference tree as the port's: tensors, an AdamState as the port's
    named tuple, a 0-d version as a Python int."""
    if isinstance(tree, dict):
        out = {k: _to_port(v) for k, v in tree.items()}
        if "version" in out:
            out["version"] = int(out["version"])
        return out
    if hasattr(tree, "_fields"):
        return interop.adam_state(jax.tree.map(np.array, tree))
    if isinstance(tree, list):
        return [_to_port(x) for x in tree]
    return torch.as_tensor(np.array(tree))


@pytest.mark.parametrize("make", [_runner_tree, _generic_tree],
                         ids=["runner", "generic"])
def test_checkpoints_cross_load_bit_identical(make, tmp_path):
    """Reference save -> port load and port save -> reference load: every
    leaf bit-identical with its dtype, the manifests' ``keys`` lists
    equal (the port builds JAX's keystr strings itself)."""
    jtree = make()
    ttree = _to_port(jtree)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    assert [k for k, _ in tckpt.keystr_leaves(ttree)] \
        == [jax.tree_util.keystr(p) for p, _ in jflat]
    jpath, tpath = str(tmp_path / "ckpt_1"), str(tmp_path / "ckpt_2")
    jckpt.save(jpath, jtree, step=1, extra={"n": 1})
    tckpt.save(tpath, ttree, step=2, extra={"n": 1})
    jm, tm = jckpt.load_manifest(jpath), tckpt.load_manifest(tpath)
    assert jm["keys"] == tm["keys"] and tm["step"] == 2
    assert jm["extra"] == tm["extra"]
    # reference file into the port
    got = tckpt.load(jpath, ttree, device="cpu")
    want = [np.asarray(x) for _, x in jflat]
    for (k, g), w in zip(tckpt.keystr_leaves(got), want):
        if isinstance(g, int):          # the port's version: a Python int
            assert g == int(w) and w.dtype == np.int32, k
            continue
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
        assert g.numpy().dtype == w.dtype, k
    if "version" in got:
        assert type(got["version"]) is int and got["version"] == 7
        assert isinstance(got["opt_state"], type(ttree["opt_state"]))
    # port file into the reference
    back = jckpt.load(tpath, jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert a.dtype == b.dtype
    with np.load(tpath + ".npz") as f, np.load(jpath + ".npz") as g:
        assert sorted(f.files) == sorted(g.files)


def test_roundtrip_extra_and_latest_step(tmp_path):
    tree = {"a": {"w": torch.randn(4, 3), "b": torch.arange(5)},
            "scale": torch.tensor(2.5), "n": 3}
    path = str(tmp_path / "ckpt_10")
    tckpt.save(path, tree, step=10, extra={"predictions": 42,
                                           "nested": {"k": [1, 2]}})
    back = tckpt.load(path, tree, device="cpu")
    for (_, a), (_, b) in zip(tckpt.keystr_leaves(tree),
                              tckpt.keystr_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and a.dtype == b.dtype
        else:
            assert a == b and type(a) is type(b)
    m = tckpt.load_manifest(path)
    assert m["step"] == 10
    assert m["extra"] == {"predictions": 42, "nested": {"k": [1, 2]}}
    for s in (3, 12, 7):
        tckpt.save(str(tmp_path / f"ckpt_{s}"), {"x": torch.ones(1)}, step=s)
    assert tckpt.latest_step(str(tmp_path)) == 12
    assert tckpt.latest_step(str(tmp_path / "missing")) is None
    assert tckpt.SAVE_STAGES == jckpt.SAVE_STAGES


def _tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.tensor(7, dtype=torch.int32)}


@pytest.mark.parametrize("stage", tckpt.SAVE_STAGES)
def test_crash_at_save_stage_keeps_a_loadable_pair(stage, tmp_path):
    """Whatever stage the crash hits, the directory holds a loadable pair,
    and both packages read it the same: the old arrays before the npz
    replace, the new ones (under the same keys) after it."""
    path = str(tmp_path / "ckpt_5")
    tckpt.save(path, _tree(), step=5)
    bumped = {"w": _tree()["w"] + 100.0, "b": torch.tensor(8,
                                                          dtype=torch.int32)}
    with pytest.raises(tfault.InjectedFault):
        tckpt.save(path, bumped, step=5,
                   fault_hook=tfault.make_save_crash_hook(stage))
    assert tckpt.steps(str(tmp_path)) == [5]
    back = tckpt.load(path, _tree(), device="cpu")
    replaced = tckpt.SAVE_STAGES.index(stage) >= 2
    assert float(back["w"].reshape(-1)[0]) == (100.0 if replaced else 0.0)
    jback = jckpt.load(path, {"w": jnp.zeros((2, 3)), "b": jnp.int32(0)})
    np.testing.assert_array_equal(np.asarray(jback["w"]),
                                  back["w"].numpy())


def test_torn_and_missing_npz(tmp_path):
    good, torn = str(tmp_path / "ckpt_1"), str(tmp_path / "ckpt_2")
    tckpt.save(good, _tree(), step=1)
    tckpt.save(torn, _tree(), step=2)
    size = os.path.getsize(torn + ".npz")
    with open(torn + ".npz", "r+b") as f:
        f.truncate(size // 3)
    with pytest.raises(ValueError, match="torn"):
        tckpt.load(torn, _tree(), device="cpu")
    assert tckpt.steps(str(tmp_path)) == [1, 2]   # present, though torn
    os.remove(torn + ".npz")
    assert tckpt.steps(str(tmp_path)) == jckpt.steps(str(tmp_path)) == [1]
    with pytest.raises(FileNotFoundError):
        tckpt.load(torn, _tree(), device="cpu")
    assert torch.equal(tckpt.load(good, _tree(), device="cpu")["w"],
                       _tree()["w"])


def test_template_key_mismatches_raise(tmp_path):
    path = str(tmp_path / "ckpt_0")
    tckpt.save(path, {"w": torch.ones(2), "b": torch.ones(3)})
    with pytest.raises(KeyError, match="not in template"):
        tckpt.load(path, {"w": torch.ones(2)}, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        tckpt.load(path, {"w": torch.ones(2), "b": torch.ones(3),
                          "extra": torch.ones(1)}, device="cpu")


def _runners():
    jenv = jax_make_env("Ant")
    tenv = interop.env_like("Ant", jenv.mega)
    jr = ja3c.AsyncRunner(jenv, [0, 1], [2], num_envs=4, num_steps=2)
    tr = ta3c.AsyncRunner(tenv, [0, 1], [2], num_envs=4, num_steps=2,
                          device="cpu")
    return jr, tr


def _controller():
    c = OnlineGMIController(num_gpu=4, serving_gpus=2, gmi_per_gpu=2,
                            num_env=64)
    for _ in range(c.cfg.epoch_rounds):
        c.record(RoundSample(samples=256, dt=0.1, occupancy=0.5, spills=0,
                             mem_bytes=1e6))
    return c


def test_runner_checkpoints_restore_across_packages(tmp_path, monkeypatch):
    """A reference runner's checkpoint restores into the port's runner and
    the port's into the reference's: params, Adam state and version bit
    for bit, the counters and the controller's tables from the manifest.
    A torn newest pair is skipped for the previous step.  (The
    reference's un-jitted ``collect`` re-traces its scan on every call;
    it runs here under ``jax.jit``, the same computation compiled once.)"""
    from repro.rl.rollout import collect
    monkeypatch.setattr(ja3c, "collect",
                        jax.jit(collect, static_argnums=(1, 5)))
    jr, tr = _runners()
    jr.round()
    tr.params = interop.policy_params(jax.tree.map(np.array, jr.params))
    tr.opt_state = interop.adam_state(jax.tree.map(np.array, jr.opt_state))
    tr.version, tr.predictions, tr.trained_samples, tr.rounds = 1, 16, 16, 1
    tr.controller = _controller()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jr.checkpoint(jd, step=1)
    tr.checkpoint(td, step=1)
    assert jckpt.load_manifest(os.path.join(jd, "ckpt_1"))["keys"] \
        == tckpt.load_manifest(os.path.join(td, "ckpt_1"))["keys"]
    jr.round()
    jr.checkpoint(jd, step=2)
    tfault.tear_checkpoint(jd, 2, mode="torn_npz")
    fresh_t = _runners()[1]
    fresh_t.controller = OnlineGMIController(num_gpu=2, serving_gpus=1,
                                             gmi_per_gpu=1, num_env=8)
    assert fresh_t.restore(jd) == 1                  # torn step 2 skipped
    fresh_j = _runners()[0]
    assert fresh_j.restore(td) == 1
    for got, want in ((fresh_t, jr_tree(jd)), (fresh_j, tr)):
        assert int(got.version) == 1
        assert (got.predictions, got.trained_samples, got.rounds) \
            == (16, 16, 1)
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(a, b)
    assert type(fresh_t.version) is int
    # the reference's manifest carries no controller: the tables stay put;
    # the port's carries one and restores it
    assert fresh_t.controller.num_gpu == 2
    assert fresh_t.restore(td) == 1
    assert json.dumps(fresh_t.controller.state_dict()) \
        == json.dumps(tr.controller.state_dict())
    assert fresh_t.controller.num_gpu == 4
    assert _runners()[1].restore(str(tmp_path / "empty")) is None


def jr_tree(directory):
    """The reference's own restore of ``directory``, the bits to match."""
    jr = _runners()[0]
    assert jr.restore(directory) == 1
    return jr


def _leaves(runner):
    tree = {"params": runner.params, "opt_state": runner.opt_state}
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for _, x in tckpt.keystr_leaves(tree)]
