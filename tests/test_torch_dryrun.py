"""The port's dry run on the CPU: the op counter
(``repro_torch/launch/hlo_analysis.py``) on toy programs against hand
counts; its ``dot_flops`` and argument bytes on reduced steps against the
reference's HLO accounting of the reference's compiled step; the kernels'
fake branch; the presets; ``run_one`` at full internlm2-1.8b width for
every shape; reanalysis of saved traces; and the utils helpers.

The reference's ``repro.launch.dryrun`` is not imported: it sets 512 host
devices for the process that imports it.  The reference's steps compile
on a 1 x 1 mesh instead, once a case (module-scoped cache).
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import utils as jutils
from repro.configs import ARCHS as JARCHS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_reduced as jget_reduced
from repro.configs.base import InputShape as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.configs.presets import preset as jpreset
from repro.launch import steps as JS
from repro.launch.hlo_analysis import analyze as janalyze
from repro.models import transformer as JT
from repro.models.moe import set_moe_sharding
from repro_torch import utils
from repro_torch.configs import INPUT_SHAPES, get_config, get_reduced
from repro_torch.configs.base import InputShape, TrainConfig
from repro_torch.configs.presets import preset
from repro_torch.kernels import _build, cost, ops, ref
from repro_torch.launch import dryrun, hlo_analysis, reanalyze
from repro_torch.launch import steps as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

B, S = 2, 64


def _counts(fn, *args, device="cpu"):
    return hlo_analysis.trace(fn, args, device)["counts"]


# ------------------------------------------------------------ toy cases ----
def test_matrix_products_count_as_by_hand():
    a, b = torch.empty(64, 32), torch.empty(32, 16)
    c = torch.empty(4, 8, 5)
    bias = torch.empty(64, 16)
    cases = [
        (lambda a, b: a @ b, (a, b), 2 * 64 * 16 * 32),
        (lambda c: torch.bmm(c, c.transpose(1, 2)), (c,), 2 * 4 * 8 * 8 * 5),
        (lambda a, b: torch.einsum("ik,kj->ij", a, b), (a, b),
         2 * 64 * 16 * 32),
        (lambda bias, a, b: torch.addmm(bias, a, b), (bias, a, b),
         2 * 64 * 16 * 32),
    ]
    for fn, args, want in cases:
        got = _counts(fn, *args)
        assert got["dot_flops"] == want
        assert got["dot_flops"] == hlo_analysis.trace(
            fn, args, "cpu")["flop_counter"]


def test_views_move_no_bytes_and_an_add_moves_its_operands():
    x = torch.empty(8, 16)
    got = _counts(lambda x: x.view(16, 8).reshape(128)[3:].unsqueeze(0).t(),
                  x)
    assert got["traffic_bytes"] == 0 and got["mem_temp_bytes"] == 0
    # x + x: two reads and one write of 512 bytes
    assert _counts(lambda x: x + x, x)["traffic_bytes"] == 3 * 8 * 16 * 4


def test_in_place_output_aliases_its_argument():
    cache, upd = torch.empty(4, 100), torch.empty(4, 10)

    def write(cache, upd):
        cache[:, :10].copy_(upd)
        return cache

    got = _counts(write, cache, upd)
    assert got["mem_argument_bytes"] == 4 * 110 * 4
    assert got["mem_alias_bytes"] == got["mem_output_bytes"] == 4 * 100 * 4
    assert got["mem_temp_bytes"] == 0


def test_peak_live_bytes_of_a_matmul_chain():
    """x (256 x 64) through four 64 x 64 layers: each product's result is
    live beside its input, then the input dies, so the peak above the
    arguments is two activations: 2 x 256 x 64 x 4 bytes.  The last one
    is the output."""
    x, w = torch.empty(256, 64), torch.empty(64, 64)

    def chain(x, w):
        h = x
        for _ in range(4):
            h = h @ w
        return h

    got = _counts(chain, x, w)
    act = 256 * 64 * 4
    assert got["mem_temp_bytes"] == 2 * act
    assert got["mem_output_bytes"] == act
    assert got["mem_argument_bytes"] == act + 64 * 64 * 4
    assert got["dot_flops"] == 4 * 2 * 256 * 64 * 64


def test_live_at_peak_names_what_the_peak_holds():
    """The matmul chain's peak (two activations above the arguments) is
    what ``hlo_analysis.live_at_peak`` finds, each activation under the
    product that made it."""
    x, w = torch.empty(256, 64), torch.empty(64, 64)

    def chain(x, w):
        h = x
        for _ in range(4):
            h = h @ w
        return h
    tr = hlo_analysis.trace(chain, (x, w), "cpu")["trace"]
    peak, held = hlo_analysis.live_at_peak(tr)
    act = 256 * 64 * 4
    assert peak == 2 * act == hlo_analysis.analyze(tr)["mem_temp_bytes"]
    assert held == [(2 * act, "aten.mm", ("f32[256,64]",))]


def test_an_argument_no_op_reads_is_not_counted():
    """jit drops unused arguments; the counter counts only what the step
    reads, so the two agree on argument bytes."""
    got = _counts(lambda a, unused: a * 2, torch.empty(10),
                  torch.empty(1000))
    assert got["mem_argument_bytes"] == 40


# ---------------------------------------------- parity with the reference --
_REF = {}


def _reference(arch, mode):
    """(dot_flops, argument bytes) of the reference's compiled reduced
    step, compiled once a case."""
    if (arch, mode) not in _REF:
        jcfg = jget_reduced(arch)
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        try:
            with mesh:
                shape = JShape("t", S, B, mode)
                if mode == "train":
                    fn, sds = JS.make_train_step(jcfg, mesh, shape, JTrain())
                elif mode == "prefill":
                    fn, sds = JS.make_prefill_step(jcfg, mesh, shape)
                else:
                    fn, sds = JS.make_serve_step(jcfg, mesh, shape)
                compiled = fn.lower(*sds).compile()
        finally:
            # the reference's step factories set module-level sharding hooks
            JT.set_activation_sharding(None)
            set_moe_sharding(None)
        _REF[arch, mode] = (
            janalyze(compiled.as_text())["dot_flops"],
            compiled.memory_analysis().argument_size_in_bytes)
    return _REF[arch, mode]


@pytest.fixture(scope="module", autouse=True)
def _drop_reference_compiles():
    yield
    _REF.clear()


@pytest.mark.parametrize("arch,mode", [
    ("internlm2-1.8b", "train"), ("internlm2-1.8b", "prefill"),
    ("internlm2-1.8b", "decode"), ("granite-moe-1b-a400m", "train"),
    ("xlstm-1.3b", "prefill")])
def test_dot_flops_and_argument_bytes_match_the_reference(arch, mode):
    """The port's plain route against the reference's loop-aware HLO
    count (xlstm's prefill: the reference's sLSTM scan multiplied by its
    trip count, the port's Python loop counted step by step).  Equal,
    but for one named gap: the train step's cross-entropy recomputes each
    chunk's logits in the backward (``models/transformer.py::
    _chunked_xent``; the reference's scan keeps them), one more
    2 x tokens x vocab x d product over the B x (S - 1) scored tokens.
    Argument bytes are equal."""
    cfg = get_reduced(arch)
    shape = InputShape("t", S, B, mode)
    if mode == "train":
        fn, args = TS.make_train_step(cfg, None, shape, TrainConfig())
    elif mode == "prefill":
        fn, args = TS.make_prefill_step(cfg, None, shape)
    else:
        fn, args = TS.make_serve_step(cfg, None, shape)
    got = hlo_analysis.trace(fn, args, "cpu")["counts"]
    want_dot, want_args = _reference(arch, mode)
    gap = 2 * B * (S - 1) * cfg.vocab_size * cfg.d_model \
        if mode == "train" else 0
    assert got["dot_flops"] == want_dot + gap
    assert got["mem_argument_bytes"] == want_args


# ------------------------------------------------------------- presets ----
def test_presets_equal_the_reference_for_every_arch_and_shape():
    for arch in JARCHS:
        for shape in JSHAPES:
            assert preset(arch, shape) == jpreset(arch, shape), (arch, shape)


# ------------------------------------------------------------ utilities ----
def test_tree_helpers_match_the_reference_on_real_meta_and_fake_trees():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.integers(0, 5, (7,)).astype(np.int32),
                  rng.standard_normal((2, 2)).astype(np.float32)]}
    ttree = utils.tree_map(torch.as_tensor, tree)
    with FakeTensorMode() as mode:
        fake = utils.tree_map(mode.from_tensor, ttree)
    meta = utils.tree_map(lambda x: x.to("meta"), ttree)
    for t in (ttree, meta, fake):
        assert utils.tree_size(t) == jutils.tree_size(tree) == 23
        assert utils.tree_bytes(t) == jutils.tree_bytes(tree) == 92
        assert utils.count_params(t) == jutils.count_params(tree)
        cast = utils.cast_tree(t, torch.bfloat16)
        assert cast["a"].dtype == torch.bfloat16
        assert cast["b"][0].dtype == torch.int32
        assert utils.tree_bytes(cast) == jutils.tree_bytes(
            jutils.cast_tree(tree, jax.numpy.bfloat16)) == 24 + 28 + 8
    utils.assert_finite(meta)
    utils.assert_finite(fake)
    utils.assert_finite(ttree)
    bad = dict(ttree, a=torch.tensor([1.0, float("nan")]))
    with pytest.raises(AssertionError, match=r"tree\['a'\]"):
        utils.assert_finite(bad)


# --------------------------------------------------------- fake kernels ----
def _kernel_calls(dev):
    """(ops wrapper call, plain version call, the wrapper's cost) of each
    kernel on small CPU inputs made by chip_smoke's input functions."""
    from repro_torch.envs import SPECS
    gen = torch.Generator(dev).manual_seed(0)
    _, st, action, obs0, consts, kw = cs.env_inputs("Ant", 8, gen, dev)
    spec = SPECS["Ant"]
    r, v, d, last = cs.gae_inputs(4, 8, gen, dev)
    dims = spec.policy_dims[:-1]
    x, ws, bs = cs.trunk_inputs(dims, 8, gen, dev)
    pay, bufs = cs.pack_inputs(4, 2, 8, spec, gen, dev, 3)
    pa = cs.paged_inputs(2, 4, 2, 64, 4, 3, [9, 5], gen, dev, torch.float32)
    fq, fk, fv = cs.flash_inputs(2, 8, 4, 2, 64, gen, dev, torch.float32)
    ml = cs.mlstm_inputs(1, 2, 8, 32, False, gen, dev)
    J = spec.act_dim
    return {
        "env_mega_step": (
            lambda *a: ops.env_mega_step(*a, None, 0, 0, *consts, **kw),
            lambda *a: ref.mega_step(*a, None, 0, 0, *consts, **kw),
            (*st, action, obs0),
            cost.env_mega_step(8, J, spec.obs_dim, kw["substeps"])),
        "gae_norm": (ops.gae_norm, ref.gae_norm_ref, (r, v, d, last),
                     cost.gae_norm(4, 8)),
        "policy_mlp": (ops.policy_mlp, ref.policy_mlp_ref, (x, ws, bs),
                       cost.policy_mlp(dims, 8)),
        "nstep_returns": (ops.nstep_returns, ref.nstep_returns_ref,
                          (r, d, last), cost.nstep_returns(4, 8)),
        "pack_channels": (
            lambda b, p: ops.pack_channels(b, p, 1),
            lambda b, p: ref.pack_channels_ref(b, p, 1), (bufs, pay),
            cost.pack_channels(4, 8, spec.obs_dim, spec.act_dim)),
        "paged_attention": (
            ops.paged_attention, ref.paged_attention_ref, pa,
            (None, 2 * 3 * 4 * 4 * 4 * 64)),
        "flash_attention": (
            ops.flash_attention, ref.attention_ref, (fq, fk, fv),
            cost.flash_attention(2, 8, 4, 2, 64, 4, True)),
        "mlstm_chunkwise": (
            lambda *a: ops.mlstm_chunkwise(*a, chunk=4),
            lambda *a: ref.mlstm_chunkwise_ref(*a, 4), ml,
            cost.mlstm_chunkwise(1, 2, 8, 32, 4)),
    }


def _shapes(tree):
    return [(tuple(t.shape), t.dtype) for t in utils.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def test_fake_kernels_return_the_plain_versions_shapes_and_record_cost():
    """Traced as the card's program, each wrapper records its kernel once
    with the cost formula's operations (paged decode: every row's whole
    table, 2 rows x 3 pages x 4 slots) and returns outputs of the plain
    version's shapes and dtypes, building and launching nothing."""
    calls = _kernel_calls(torch.device("cpu"))
    assert set(calls) == set(ops.LAUNCHES)
    ops.reset_launches()
    for name, (wrapper, plain, args, (_, nops)) in calls.items():
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fargs = utils.tree_map(
                lambda t: mode.from_tensor(t) if isinstance(t, torch.Tensor)
                else t, args)
            want = _shapes(plain(*fargs))
            counter = hlo_analysis.OpCounter(card=True)
            with counter:
                got = wrapper(*fargs)
        assert _shapes(got) == want, name
        kernels = [e for e in counter.events if e[0] == "kernel"]
        assert kernels == [["kernel", name, cost.op_count(nops),
                            kernels[0][3]]], name
    assert not any(ops.LAUNCHES.values())


def test_a_card_trace_records_kernels_by_name_and_never_builds(monkeypatch):
    """A traced xlstm prefill on the card's route goes through the flash
    and mLSTM kernels' fake branch: recorded by name, never near
    ``_build`` (which would need nvcc), no launch counted."""
    def refuse(*a, **k):
        raise AssertionError("a traced step reached the kernel build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    cfg = get_reduced("zamba2-7b")
    fn, args = TS.make_prefill_step(cfg, None, InputShape("p", S, B,
                                                          "prefill"))
    ops.reset_launches()
    card = hlo_analysis.trace(fn, args, "cuda")["counts"]
    plain = hlo_analysis.trace(fn, args, "cpu")["counts"]
    assert card["kernel_calls"] == {"flash_attention": cfg.num_super}
    assert plain["kernel_calls"] == {}
    assert not any(ops.LAUNCHES.values())
    # the plain attention's products are the kernel's on the card
    assert card["dot_flops"] < plain["dot_flops"]
    cfg = get_reduced("xlstm-1.3b")
    fn, args = TS.make_prefill_step(cfg, None, InputShape("p", S, B,
                                                          "prefill"))
    card = hlo_analysis.trace(fn, args, "cuda")["counts"]
    n_mlstm = cfg.block_pattern.count("mlstm") * cfg.num_super
    assert card["kernel_calls"] == {"mlstm_chunkwise": n_mlstm}


# ------------------------------------------------------------- run_one ----
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_run_one_full_internlm2_records(shape_name):
    """internlm2-1.8b at its published width for every input shape on
    the card's route: the record carries the reference's keys, the whole
    step's counts, one flash call a layer in prefill and two in train
    (the forward and its remat recompute; the backward differentiates the
    plain version), the arguments the step reads, the mesh's per-chip
    argument bytes, and the SPMD-only fields traced from rank 0's program
    on the (16, 16) mesh: each rank computes 1/256 of the whole step's
    products (no product is computed twice), except long_500k's batch of
    one, which every rank of ``data`` repeats (16 times the share); the
    rank moves bytes, holds temporaries and none of them cross a pod."""
    arch = "internlm2-1.8b"
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    rec = dryrun.run_one(arch, shape_name, False)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["compile_s"] is None and rec["lower_s"] >= 0
    assert rec["per_device_scope"] == "rank 0 of the mesh"
    for k in dryrun.SPMD_ONLY:
        assert rec[k] > 0, k
    assert rec["cross_pod_bytes"] == 0.0
    assert rec["per_device_mem_bytes"] == rec["per_device_argument_bytes"] \
        + rec["per_device_temp_bytes"]
    # the rank's shards are the specs' per-chip bytes, but prefill's
    # labels, which no op reads
    unread = shape.global_batch * shape.seq_len * 4 // 16 \
        if shape.mode == "prefill" else 0
    assert rec["per_device_argument_bytes"] == \
        rec["mem_argument_bytes_per_device"] - unread
    want = 16 if shape_name == "long_500k" else 1
    assert rec["per_device_dot_flops"] * 256 == pytest.approx(
        want * rec["hlo_dot_flops"], rel=1e-9)
    assert rec["dot_redundancy"] == pytest.approx(want, rel=1e-9)
    assert rec["mem_per_device_bytes"] == rec["mem_argument_bytes"] \
        + rec["mem_temp_bytes"]
    L, D = cfg.num_layers, cfg.d_model
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    params = utils.tree_bytes(TS.abstract_train_state(cfg)[0])
    tokens = shape.global_batch * shape.seq_len * 4
    if shape.mode in ("train", "prefill"):
        per = cost.flash_attention(shape.global_batch, shape.seq_len, H, KH,
                                   hd, 2, True)
        # train: the remat recompute of each layer calls it again
        n = 2 * L if shape.mode == "train" else L
        assert rec["kernel_calls"] == {"flash_attention": n}
        assert rec["kernel_flops"]["flash_attention"] == n * per[1]
        assert rec["kernel_bytes"]["flash_attention"] == n * per[0]
    else:
        assert rec["kernel_calls"] == {}
    if shape.mode == "train":
        # bf16 params, f32 moments, the int32 step, tokens and labels
        assert rec["mem_argument_bytes"] == 5 * params + 4 + 2 * tokens
        assert rec["mem_argument_bytes_per_device"] < \
            rec["mem_argument_bytes"] // 16
        assert rec["hlo_dot_flops"] > 6 * (params // 2) * tokens // 4 * 0.9
    elif shape.mode == "prefill":
        assert rec["mem_argument_bytes"] == params + tokens
    else:
        assert rec["mem_alias_bytes"] > 0     # the cache, written in place
        assert rec["mem_argument_bytes"] >= params + rec["mem_alias_bytes"]
    assert rec["collective_bytes"] == 0 and rec["coll_counts"] == {}
    assert rec["hlo_flops_costan"] >= rec["hlo_dot_flops"]


def test_run_one_follows_shape_skips_and_the_long_context_window():
    rec = dryrun.run_one("hubert-xlarge", "decode_32k", False)
    assert rec["status"] == "skip" and "encoder-only" in rec["reason"]
    rec = dryrun.run_one("internlm2-1.8b", "long_500k", True)
    assert rec["window_override"] == 4096 and rec["chips"] == 512


# ---------------------------------------------------------- reanalysis ----
def test_save_and_reanalyze_give_the_same_fields(tmp_path):
    out, hlo = tmp_path / "dryrun", tmp_path / "hlo"
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(out), "--save-hlo",
                 str(hlo)])
    (path,) = out.glob("*.json")
    before = json.loads(path.read_text())
    assert (hlo / "internlm2-1.8b_decode_32k_single.hlo.gz").exists()
    assert (hlo / "internlm2-1.8b_decode_32k_single_rank0.hlo.gz").exists()
    changed = dict(before, hlo_dot_flops=-1.0, mem_temp_bytes=-1,
                   per_device_dot_flops=-1.0, per_device_temp_bytes=-1)
    path.write_text(json.dumps(changed))
    reanalyze.main(["--dryrun", str(out), "--hlo", str(hlo)])
    after = json.loads(path.read_text())
    for k in list(reanalyze.FIELDS) + list(reanalyze.RANK_FIELDS):
        assert after[k] == before[k], k
    assert after["mem_per_device_bytes"] == before["mem_per_device_bytes"]
