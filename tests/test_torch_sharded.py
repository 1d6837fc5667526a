"""Sharded LM steps (``launch/steps.py`` on a ``DeviceMesh``,
``dist/spmd.py``, ``dist/partition.py``'s placements, ``checkpoint``'s
``placements=``) on the CPU, and one rank's program under the ``fake``
process group (``launch/hlo_analysis.py``, ``launch/dryrun.py``).

Four gloo ranks on a (data 2, model 2) mesh, spawned from
``tests/_torch_sharded_worker.py`` once per family of cases, run reduced
configs on params carried over from the JAX package; every result is
gathered to full tensors.  The gates:

* the HAR train step's loss within 2e-4 of the JAX package's
  single-device ``loss_fn`` (the reference's own tolerance in
  ``check_sharded_train_step``), and every step's loss within 1e-5 of the
  port's unsharded step;
* Adam's moments within 1e-5 of the unsharded step's, and the params
  within 1e-5 wherever the gradient exceeds 1e-7.  At one Adam step the
  update is ``lr * g / (|g| + 1e-8)``, so a gradient near 1e-8 (a
  cancellation) turns float32 rounding of the gradient, which a sharded
  sum orders differently, into a sizeable share of ``lr``: there the
  params are held within ``lr``, the most one step can move them;
* prefill logits within 1e-5, the served token identical, in f32; at
  the recurrent archs (their blocks on their cache's ``model`` split)
  every state leaf within 1e-5 after prefill and after a decode step,
  each cache leaf in its ``cache_specs`` placement throughout, and the
  prefill logits within 2e-4 of the JAX package's;
* a checkpoint restored onto placements bit-identical, with them;
* the global-norm clip: the norm and the clipped update equal the
  unsharded ones.
"""
import functools
import multiprocessing
import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.checkpoint.ckpt import keystr_leaves
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import InputShape, TrainConfig
from repro_torch.data import make_batch
from repro_torch.dist import partition
from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as TS
from repro_torch.optim import adam_init, adam_update
from repro_torch.utils import global_norm, tree_map

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_sharded_worker as worker  # noqa: E402

B, S = 4, 32
LR = TrainConfig().learning_rate
DENSE = "internlm2-1.8b"
DENSE_CASES = ["train/har/contract", "train/mrr/contract", "serve", "ckpt",
               "clip"]
OTHER = {"granite-moe-1b-a400m": ["train/har/contract",
                                  "train/har/expert"],
         "xlstm-1.3b": ["train/har/contract", "serve"],
         "xlstm-1.3b/h1": ["train/har/contract", "serve"],
         "zamba2-7b": ["train/har/contract", "serve"]}
RECURRENT = ["xlstm-1.3b", "xlstm-1.3b/h1", "zamba2-7b"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jcfg(name):
    """The JAX package's reduced config of ``name`` (``ARCH/h1``: with
    one head, as ``worker.reduced``)."""
    arch, _, tag = name.partition("/")
    cfg = jget_reduced(arch)
    return cfg.replace(num_heads=1, num_kv_heads=1) if tag == "h1" else cfg


def _inputs(arch, seed=3):
    """(reference params, port params as numpy, batch) for ``arch``."""
    jp = JT.init_model(jax.random.key(seed), _jcfg(arch))
    npp = jax.tree.map(np.asarray, jp)
    batch = make_batch(worker.reduced(arch), InputShape("t", S, B, "train"),
                       seed=seed)
    return jp, interop.to_numpy(interop.model_params(npp)), dict(batch)


def _spawn(payload, tmp):
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    out = str(tmp / "rank0.npz")
    procs = [ctx.Process(target=worker.run,
                         args=(r, 4, port, payload, out,
                               str(tmp / "ckpt")))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive), "a gloo rank did not finish within 240 s"
    assert [p.exitcode for p in procs] == [0] * 4
    return dict(np.load(out))


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    jp, npp, batch = _inputs(DENSE)
    res = _spawn([(DENSE, npp, batch, DENSE_CASES)],
                 tmp_path_factory.mktemp("dense"))
    return jp, worker._tensors(npp), worker._tensors(batch), res


@pytest.fixture(scope="module")
def other(tmp_path_factory):
    inputs = {a: _inputs(a) for a in OTHER}
    res = _spawn([(a, inputs[a][1], inputs[a][2], OTHER[a]) for a in OTHER],
                 tmp_path_factory.mktemp("other"))
    return ({a: (worker._tensors(v[1]), worker._tensors(v[2]))
             for a, v in inputs.items()}, res)


def _unsharded_step(arch, params, batch):
    fn, _ = TS.make_train_step(worker.reduced(arch), None, None,
                               TrainConfig())
    return fn(params, adam_init(params), batch)


def _held_step(res, tag, params2, opt2):
    """Gathered params and Adam moments against the unsharded step's (see
    the module docstring)."""
    for name, tree in (("mu", opt2.mu), ("nu", opt2.nu)):
        for k, v in keystr_leaves(tree):
            np.testing.assert_allclose(res[f"{tag}/{name}{k}"], v.numpy(),
                                       rtol=0, atol=1e-5, err_msg=name + k)
    mu = dict(keystr_leaves(opt2.mu))
    for k, v in keystr_leaves(params2):
        got, want = res[f"{tag}/params{k}"], v.numpy()
        live = np.abs(mu[k].numpy()) > 1e-8          # |g| > 1e-7
        err = np.abs(got - want)
        assert err[live].max(initial=0.0) <= 1e-5, k
        assert err.max() <= LR, k
    assert bool(res[f"{tag}/placed"].all())


# ------------------------------------------------------------- dense ------
def test_har_step_loss_matches_jax_single_device(dense):
    """The (data 2, model 2) HAR step's loss is the JAX package's
    single-device ``loss_fn`` on the same numpy inputs, within 2e-4."""
    jp, _, _, res = dense
    cfg = jget_reduced(DENSE)
    _, _, batch = _inputs(DENSE)
    want = float(JT.loss_fn(jp, cfg, {k: jnp.asarray(v)
                                      for k, v in batch.items()}))
    assert abs(float(res[f"{DENSE}/train/har/contract/loss"]) - want) \
        <= 2e-4


@pytest.mark.parametrize("lgr", ["har", "mrr"])
def test_step_matches_unsharded(dense, lgr):
    """HAR (FSDP over ``data``: reduced internlm2's two layers put it on
    the layer dim, each layer gathered from its rank) and MRR (params
    replicated over ``data``): loss, params and Adam state against the
    port's unsharded step; params come back in their placements."""
    _, params, batch, res = dense
    tag = f"{DENSE}/train/{lgr}/contract"
    p2, o2, m = _unsharded_step(DENSE, params, batch)
    assert abs(float(res[f"{tag}/loss"]) - float(m["loss"])) <= 1e-5
    _held_step(res, tag, p2, o2)


def test_prefill_and_serve_match_unsharded(dense):
    """Prefill logits within 1e-5 and every cache leaf within 1e-5 of the
    unsharded prefill; one decode step on those caches picks the same
    tokens."""
    _, params, batch, res = dense
    cfg = get_reduced(DENSE)
    fn, _ = TS.make_prefill_step(cfg, None, InputShape("p", S, B,
                                                       "prefill"))
    logits, caches = fn(params, batch)
    np.testing.assert_allclose(res[f"{DENSE}/prefill/logits"],
                               logits.numpy(), rtol=0, atol=1e-5)
    for k, v in keystr_leaves(caches):
        np.testing.assert_allclose(res[f"{DENSE}/prefill/cache{k}"],
                                   v.numpy(), rtol=0, atol=1e-5)
    sfn, _ = TS.make_serve_step(cfg, None, InputShape("d", S, B, "decode"))
    tok = torch.argmax(logits, -1).to(torch.int32)
    lg, _ = sfn(params, caches, tok, torch.full((B,), S, dtype=torch.int32))
    np.testing.assert_array_equal(res[f"{DENSE}/serve/token"],
                                  torch.argmax(lg, -1).numpy())
    np.testing.assert_allclose(res[f"{DENSE}/serve/logits"], lg.numpy(),
                               rtol=0, atol=1e-5)


def test_checkpoint_restores_onto_placements(dense):
    """A DTensor tree saved whole (the reference's format) and loaded with
    ``placements=``: every leaf bit-identical, in its placements, and the
    file holds the full tensors."""
    _, params, _, res = dense
    assert bool(res["ckpt/same"].all()) and res["ckpt/same"].size > 0
    for k, v in keystr_leaves(params):
        np.testing.assert_array_equal(res[f"ckpt/full{k}"], v.numpy())


def test_global_norm_clip_equals_unsharded(dense):
    """The clip's norm is the whole tree's, reduced once, not a shard's:
    it and the clipped Adam update equal the unsharded ones."""
    _, params, _, res = dense
    grads = tree_map(lambda x: torch.cos(x * 3.0), params)
    np.testing.assert_allclose(res["clip/norm"],
                               global_norm(grads).numpy(), rtol=1e-6)
    p2, _ = adam_update(grads, adam_init(params), params, lr=1e-2,
                        grad_clip=0.5)
    for k, v in keystr_leaves(p2):
        np.testing.assert_allclose(res[f"clip/params{k}"], v.numpy(),
                                   rtol=0, atol=1e-6)


# ------------------------------------------------- MoE and recurrent ------
@pytest.mark.parametrize("arch,case", [(a, c) for a in OTHER
                                       for c in OTHER[a]
                                       if c.startswith("train")])
def test_other_steps_match_unsharded(other, arch, case):
    """A reduced MoE stack under ``moe_spec="contract"`` and
    ``"expert"``, and the recurrent stacks (their blocks on each rank's
    batch rows and ``model`` share: zamba2's Mamba2 on its heads, xlstm's
    mLSTM on its value rows, its sLSTM's projections split, the
    recurrence on its heads or, with one head, whole): loss, params and
    Adam state against the unsharded step."""
    inputs, res = other
    params, batch = inputs[arch]
    tag = f"{arch}/{case}"
    p2, o2, m = _unsharded_step(arch, params, batch)
    assert abs(float(res[f"{tag}/loss"]) - float(m["loss"])) <= 1e-5
    _held_step(res, tag, p2, o2)


def _unsharded_serve(arch, params, batch):
    """The port's unsharded prefill (logits, caches) and one decode step
    on those caches (logits, caches), as the worker runs them."""
    cfg = worker.reduced(arch)
    fn, _ = TS.make_prefill_step(cfg, None, InputShape("p", S, B,
                                                       "prefill"))
    logits, caches = fn(params, {"tokens": batch["tokens"],
                                 "labels": batch["labels"]})
    pre = [(k, v.clone()) for k, v in keystr_leaves(caches)]
    sfn, _ = TS.make_serve_step(cfg, None, InputShape("d", S, B, "decode"))
    lg, caches = sfn(params, caches, torch.argmax(logits, -1).to(
        torch.int32), torch.full((B,), S, dtype=torch.int32))
    return logits, pre, lg, list(keystr_leaves(caches))


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_serve_matches_unsharded(other, arch):
    """Prefill logits within 1e-5 and the served token identical, with
    the recurrent blocks on their cache's ``model`` split (Mamba2 on
    ``h``'s head dim, the mLSTM on ``C``'s value rows, the sLSTM's
    recurrence on its heads, or whole with one head) and their states
    written back into their placed caches: every state leaf within 1e-5
    of the unsharded step's after prefill and after the decode step, the
    decode logits within 1e-5."""
    inputs, res = other
    params, batch = inputs[arch]
    logits, pre, lg, post = _unsharded_serve(arch, params, batch)
    np.testing.assert_allclose(res[f"{arch}/prefill/logits"],
                               logits.numpy(), rtol=0, atol=1e-5)
    for tag, leaves in (("prefill", pre), ("serve", post)):
        for k, v in leaves:
            np.testing.assert_allclose(res[f"{arch}/{tag}/cache{k}"],
                                       v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=tag + k)
    np.testing.assert_array_equal(res[f"{arch}/serve/token"],
                                  torch.argmax(lg, -1).numpy())
    np.testing.assert_allclose(res[f"{arch}/serve/logits"], lg.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_caches_keep_their_placements(other, arch):
    """Every cache leaf stays in its ``cache_specs`` placement through the
    prefill and the decode step, its local tensor the split shard (at
    (2, 2): Mamba2's ``h`` cut on its head dim, the mLSTM's ``C`` on its
    value rows, the sLSTM's states on their heads, whole with one head);
    the states are written in place, never gathered and split again."""
    _, res = other
    for tag in ("prefill", "serve"):
        placed = res[f"{arch}/{tag}/placed"]
        assert placed.size > 0 and bool(placed.all()), (tag, placed)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_matches_jax(other, arch):
    """The (data 2, model 2) prefill's logits within 2e-4 of the JAX
    package's reduced prefill (``repro.launch.steps.make_prefill_step``
    on one device) from the same numpy weights."""
    from repro.launch import steps as JS
    from repro.configs.base import InputShape as JShape
    from repro.models.moe import set_moe_sharding
    _, res = other
    jp, _, batch = _inputs(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    try:
        with mesh:
            fn, _ = JS.make_prefill_step(_jcfg(arch), mesh,
                                         JShape("p", S, B, "prefill"))
            want, _ = fn(jp, {k: jnp.asarray(batch[k])
                              for k in ("tokens", "labels")})
    finally:
        # the reference's step factories set module-level sharding hooks
        JT.set_activation_sharding(None)
        set_moe_sharding(None)
    np.testing.assert_allclose(res[f"{arch}/prefill/logits"],
                               np.asarray(want), rtol=0, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _decode_cell(arch):
    """The dry run's decode_32k record of ``arch`` at full width on the
    (16, 16) mesh, traced once for the tests that read it, with the bytes
    of rank 0's collectives by op (``coll_by_name``, from its trace)."""
    import tempfile
    from repro_torch.launch import dryrun
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cell.hlo.gz")
        rec = dryrun.run_one(arch, "decode_32k", False, save_hlo=path)
        trace = hlo_analysis.load_trace(path.replace(".hlo.gz",
                                                     "_rank0.hlo.gz"))
    assert rec["status"] == "ok"
    by_name = {}
    for ev in trace["events"]:
        ns, _, op = ev[1].partition(".")
        if ev[0] == "op" and ns in hlo_analysis._COLL_NAMESPACES and \
                op in hlo_analysis._COLLECTIVES:
            by_name[ev[1]] = by_name.get(ev[1], 0) + sum(
                hlo_analysis._nbytes(s) for s in ev[3])
    rec["coll_by_name"] = by_name
    return rec


@pytest.mark.parametrize("arch,bound", [("zamba2-7b", 1.2),
                                        ("xlstm-1.3b", 1.5)])
def test_recurrent_decode_rank_repeats_little(arch, bound):
    """The dry run's decode_32k cell at full width on the (16, 16) mesh:
    rank 0's program (traced under the ``fake`` group) computes at most
    ``bound`` times its 1/256 share of the whole step's products, its
    recurrent blocks on their cache's ``model`` split (before the split:
    x9.708 at zamba2-7b, x14.901 at xlstm-1.3b)."""
    assert 1.0 <= _decode_cell(arch)["dot_redundancy"] <= bound


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_recurrent_decode_rank_receives_its_weight_share(arch):
    """In the same cell each recurrent block's weights reach rank 0 cut to
    the entries it computes with, by one all-to-all over ``model`` a
    weight (``all_to_all_single``; DTensor's own all-to-all, which
    re-splits zamba2's shared attention weights, is counted apart): those
    all-to-alls carry at most 1.2 x the rank's 1/16 of the recurrent
    blocks' bf16 weights (Mamba2's B, C and dt columns are whole on every
    rank), and all the rank's collectives move under a quarter of those
    weights (gathered whole, they moved more than all of them:
    13,460,358,400 B at zamba2-7b and 3,955,994,624 B at xlstm-1.3b)."""
    from repro_torch.models import transformer as T
    kinds = ("mamba2_", "mlstm_", "slstm_")
    params = T.init_abstract(get_config(arch))["super"]
    rec_bytes = 2 * sum(v.numel() for k, sub in params.items()
                        if k.startswith(kinds)
                        for _, v in keystr_leaves(sub))
    rec = _decode_cell(arch)
    a2a = rec["coll_by_name"]["_c10d_functional.all_to_all_single"]
    assert 0 < a2a <= 1.2 * rec_bytes / 16, (a2a, rec_bytes)
    assert rec["per_device_coll_by_op"]["all-to-all"] == a2a + \
        rec["coll_by_name"].get("_dtensor.shard_dim_alltoall", 0)
    assert rec["per_device_collective_bytes"] < rec_bytes / 4, \
        (rec["per_device_collective_bytes"], rec_bytes)


# ----------------------------------------------------- one fake rank ------
@pytest.fixture
def fake4():
    """This process as rank 0 of a fake world of 4, on a (data 2, model 2)
    DeviceMesh; with a pod axis, (pod 2, data 1, model 2)."""
    from repro_torch.launch.dryrun import fake_world

    def make(shape, axes):
        return mesh_lib.device_mesh(mesh_lib.make_mesh(shape, axes), "cpu")
    with fake_world(4):
        yield make


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_placements_follow_specs_every_arch(multi):
    """Every arch at full size on the production mesh: each spec entry
    becomes ``Shard(dim)`` on its axis's mesh dim and every other mesh dim
    ``Replicate()``; rank 0's shard is the leaf cut by the axes' sizes."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist import spmd
    from repro_torch.launch.dryrun import fake_world
    mesh = mesh_lib.make_production_mesh(multi_pod=multi)
    with fake_world(mesh.size):
        dm = mesh_lib.device_mesh(mesh, "cpu")
        for arch in ARCHS:
            params = TS.abstract_train_state(get_config(arch))[0]
            specs = partition.param_specs(params, mesh, fsdp=True)
            pls = partition.to_placements(specs, dm)
            for x, s, pl in zip(partition.tree_leaves(params),
                                partition.tree_leaves(
                                    specs, is_leaf=partition.is_spec),
                                partition.tree_leaves(
                                    pls, is_leaf=lambda t: isinstance(
                                        t, tuple) and all(not isinstance(
                                            e, (str, tuple, type(None)))
                                            for e in t))):
                want = [Replicate()] * dm.ndim
                shape = list(x.shape)
                for d, e in enumerate(s):
                    for ax in (e if isinstance(e, tuple) else (e,)):
                        if ax:
                            want[mesh.axis_names.index(ax)] = Shard(d)
                            shape[d] //= mesh.shape[ax]
                assert list(pl) == want, (arch, s, pl)
                sl = spmd.local_slices(x.shape, pl, dm)
                assert [c.stop - c.start for c in sl] == shape


def test_device_mesh_needs_matching_world(fake4):
    """A mesh of another size than the world is refused."""
    with pytest.raises(ValueError):
        fake4((2, 4), ("data", "model"))


def test_trace_counts_known_program(fake4):
    """A known (2, 2) program traced as rank 0: a column-parallel product
    of a batch-split input (one all-gather of the weight's data shards,
    no other collective), a sum reduced over ``model`` (one all-reduce of
    4 bytes), the local product's FLOPs, DTensor's own propagation ops
    left out; on (pod 2, data 1, model 2) the same reduction over ``pod``
    counts as cross-pod bytes."""
    from torch.distributed.tensor import Replicate
    from repro_torch.dist import spmd
    dm = fake4((2, 2), ("data", "model"))

    def prog(x, w):
        y = spmd.col(x, {"w": w})                 # (8, 16) split over model
        return spmd.layout(y.sum(), [Replicate()] * 2)

    def place(args, dev):
        x, w = args
        return (partition.empty_placed(x, ("data", None), dm, dev, False),
                partition.empty_placed(w, ("data", "model"), dm, dev, False))
    args = (torch.empty(8, 32, device="meta"),
            torch.empty(32, 16, device="meta"))
    c = hlo_analysis.trace(prog, args, "cuda", place=place,
                           dmesh=dm)["counts"]
    # rank 0: x (4, 32) @ w (32, 8) after gathering w's rows over data
    assert c["dot_flops"] == 2 * 4 * 8 * 32
    assert c["coll_counts"] == {"all-gather": 1, "all-reduce": 2}
    assert c["coll_by_op"]["all-gather"] == 32 * 8 * 4
    assert c["coll_by_op"]["all-reduce"] == 4 + 4
    assert c["cross_pod_bytes"] == 0.0
    assert c["mem_argument_bytes"] == (4 * 32 + 16 * 8) * 4


def test_trace_counts_a_gathered_buffer_once(fake4):
    """Peak bytes of a (2, 2) program that gathers a column split (the
    all-gather stacks the shards as rows, then one ``cat`` lays them side
    by side) and sums the result: on fake tensors the collective's wait
    returns its result under a storage object of its own, which the
    counter counts as the gathered buffer, once.  The trace's peak equals
    the counter's over the same program on real local tensors, and the
    bytes the program holds at once: the stacked (16, 16) f32 buffer and
    the (8, 32) one the ``cat`` writes."""
    from torch.distributed.tensor import Replicate
    from repro_torch.dist import spmd
    dm = fake4((2, 2), ("data", "model"))

    def prog(x):
        return spmd.layout(x, [Replicate()] * 2).sum()

    def place(args, dev):
        return (partition.empty_placed(args[0], (None, "model"), dm, dev,
                                       False),)
    x = torch.empty(8, 32, device="meta")
    traced = hlo_analysis.trace(prog, (x,), "cuda", place=place,
                                dmesh=dm)["counts"]
    real = place((x,), "cpu")
    counter = hlo_analysis.OpCounter()
    counter.watch(real)
    with counter:
        out = prog(*real)
    counter.finish(out)
    counted = hlo_analysis.analyze(counter.trace())
    assert traced["coll_counts"] == {"all-gather": 1}
    assert traced["mem_temp_bytes"] == counted["mem_temp_bytes"] \
        == 2 * 8 * 32 * 4


def _direct_alltoall(group, shape, gather_dim, shard_dim):
    """The op counter's trace of DTensor's all-to-all called as the card's
    route calls it, on a fake f32 tensor of ``shape``, then doubled."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import torch.distributed.tensor  # noqa: F401  (registers _dtensor ops)
    with FakeTensorMode() as mode:
        x = torch.empty(*shape)
        counter = hlo_analysis.OpCounter(card=True, fake_mode=mode)
        counter.watch((x,))
        with counter:
            y = torch.ops._dtensor.shard_dim_alltoall(
                x, gather_dim, shard_dim, group) * 2
        counter.finish(y)
    return counter.trace()


def test_trace_counts_alltoall_result_bytes(fake4):
    """DTensor's all-to-all (a split moved from one dim to another) is a
    collective, counted as an all-to-all at its result's bytes, and
    allocated at them: on the card the result is a buffer of its own,
    where some PyTorch versions' fake kernel returns a view into a buffer
    the group's size times larger."""
    group = fake4((2, 2), ("data", "model")).get_group("model").group_name
    tr = _direct_alltoall(group, (8, 6), 0, 1)
    ev = tr["events"][0]
    assert ev[1] == "_dtensor.shard_dim_alltoall"
    assert ev[3] == ["f32[16,3]"] and ev[4][0][1] == 16 * 3 * 4
    c = hlo_analysis.analyze(tr)
    assert c["coll_counts"] == {"all-to-all": 1}
    assert c["coll_by_op"] == {"all-to-all": 16 * 3 * 4}
    assert c["collective_bytes"] == 16 * 3 * 4 and c["cross_pod_bytes"] == 0


@pytest.mark.parametrize("axis", ["model", "pod"])
def test_trace_counts_cpu_alltoall_as_the_cards(axis):
    """A DTensor redistribution from Shard(0) to Shard(1) over ``axis`` of
    a CPU mesh, which DTensor runs as an all-gather of every rank's input,
    the rank's chunk and a copy, traces as the card's route: one
    all-to-all at its result's bytes (over ``pod``, cross-pod bytes), the
    same events, collectives and peak as DTensor's all-to-all called
    directly (ROADMAP C18)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist import spmd
    from repro_torch.launch.dryrun import fake_world
    axes = ("pod", "data", "model")
    with fake_world(4):
        dm = mesh_lib.device_mesh(mesh_lib.make_mesh((2, 1, 2), axes), "cpu")
        pl = [Replicate()] * 3
        pl[axes.index(axis)] = Shard(1)

        def place(args, dev):
            return (partition.empty_placed(args[0], (axis, None), dm, dev,
                                           False),)
        cpu = hlo_analysis.trace(lambda x: spmd.layout(x, pl) * 2,
                                 (torch.empty(8, 12, device="meta"),),
                                 "cuda", place=place, dmesh=dm)["trace"]
        card = _direct_alltoall(dm.get_group(axis).group_name, (4, 12), 0, 1)
    assert [ev[:7] for ev in cpu["events"]] == \
        [ev[:7] for ev in card["events"]]
    c, d = hlo_analysis.analyze(cpu), hlo_analysis.analyze(card)
    assert c["coll_counts"] == d["coll_counts"] == {"all-to-all": 1}
    assert c["coll_by_op"] == d["coll_by_op"] == {"all-to-all": 8 * 6 * 4}
    assert c["mem_temp_bytes"] == d["mem_temp_bytes"] == 2 * 8 * 6 * 4
    assert c["cross_pod_bytes"] == (8 * 6 * 4 if axis == "pod" else 0)


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_dot_redundancy_is_the_same_traced_for_either_device(shape):
    """granite-moe-1b-a400m at full width, one layer, on (16, 16): traced
    for the card (kernels recorded; the flash backward recomputes the
    plain attention) and for the CPU (the plain attention in the kernel's
    place, DTensor on a CPU mesh), rank 0 reads the same
    ``dot_redundancy`` and the same collectives (ROADMAP C18).  The two
    programs' products differ: the CPU's plain forward computes the full
    score square that the card's kernel counts as causal pairs in
    ``kernel_flops``; the ratio leaves every kernel's forward out on both
    devices."""
    from repro_torch.launch import dryrun
    card, cpu = (dryrun.run_one("granite-moe-1b-a400m", shape, False,
                                cfg_overrides={"num_layers": 1}, device=d)
                 for d in ("cuda", "cpu"))
    assert card["per_device_kernel_calls"]["flash_attention"] > 0
    assert cpu["per_device_plain_fwd_dot_flops"] > 0
    assert card["hlo_dot_flops"] != cpu["hlo_dot_flops"]
    assert card["dot_redundancy"] == cpu["dot_redundancy"]
    for k in ("per_device_coll_by_op", "per_device_coll_counts",
              "per_device_collective_bytes"):
        assert card[k] == cpu[k], k


def test_row_parallel_backward_keeps_its_split(fake4):
    """A row-parallel product (``spmd.row``: ``h``'s features and ``w``'s
    rows split over ``model``) whose output gradient arrives as a partial
    sum over ``model``: the gradient is summed once (one all-reduce) and
    both gradients are computed on the rank's split, 3 x 2 x 16 x 8 x 12
    FLOPs with the forward.  Left partial, PyTorch 2.13's DTensor gathers
    ``h`` and ``w`` whole and computes the gradients in full on every
    rank (ROADMAP C18: zamba2-7b train_4k read x1.157 for x1.058 at one
    super-block)."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from repro_torch.dist import spmd
    dm = fake4((2, 2), ("data", "model"))

    def prog(h, w):
        h, w = h.detach().requires_grad_(), w.detach().requires_grad_()
        y = spmd.row(h, {"w": w})
        g = DTensor.from_local(torch.ones(2, 8, 12), dm,
                               [Shard(0), Partial()])
        return torch.autograd.grad(y, (h, w), g)

    def place(args, dev):
        return (partition.empty_placed(args[0], ("data", None, "model"), dm,
                                       dev, False),
                partition.empty_placed(args[1], ("model", None), dm, dev,
                                       False))
    c = hlo_analysis.trace(prog, (torch.empty(4, 8, 16, device="meta"),
                                  torch.empty(16, 12, device="meta")),
                           "cuda", place=place, dmesh=dm)["counts"]
    assert c["dot_flops"] == 3 * 2 * 16 * 8 * 12
    assert c["coll_by_op"] == {"all-reduce": 2 * 8 * 12 * 4}


def test_trace_counts_cross_pod_bytes():
    """A sum over a batch split over ``pod``: its all-reduce over the pod
    group counts as cross-pod bytes, the one over ``model`` does not."""
    from torch.distributed.tensor import Replicate
    from repro_torch.dist import spmd
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4):
        dm = mesh_lib.device_mesh(
            mesh_lib.make_mesh((2, 1, 2), ("pod", "data", "model")), "cpu")

        def place(args, dev):
            return (partition.empty_placed(args[0], ("pod", "model"), dm,
                                           dev, False),)
        c = hlo_analysis.trace(lambda x: spmd.layout(x.sum(),
                                                     [Replicate()] * 3),
                               (torch.empty(8, 6, device="meta"),), "cuda",
                               place=place, dmesh=dm)["counts"]
    assert c["coll_counts"] == {"all-reduce": 2}
    assert c["cross_pod_bytes"] == 4.0


def test_flash_backward_in_row_chunks_equals_whole(monkeypatch):
    """The flash Function's backward recomputes the plain route over
    chunks of batch rows when a row's scores exceed the bound: the
    gradients equal the unchunked backward's (the launch stood in by the
    plain version, as on the card the kernel runs)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    monkeypatch.setattr(ops, "_on_cpu", lambda x, op: False)
    monkeypatch.setattr(fa, "launch", lambda q, k, v, **kw:
                        ref.attention_ref(q, k, v, **kw))
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(5, 24, h, 16, generator=gen)
               for h in (4, 2, 2))
    g = torch.randn(5, 24, 4, 16, generator=gen)

    def grads(bound):
        monkeypatch.setattr(ops, "BACKWARD_SCORE_BYTES", bound)
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = ops.flash_attention(*xs, causal=True, scale=0.25)
        return torch.autograd.grad(out, xs, g)
    whole = grads(1 << 30)
    for bound in (4 * 24 * 24 * 4, 2 * 4 * 24 * 24 * 4):   # 1 and 2 rows
        for a, b in zip(grads(bound), whole):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
