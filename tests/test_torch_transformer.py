"""The port's model stack (``repro_torch/models/transformer.py``,
``layers.py``) and configs against the JAX package on the CPU, at the
reduced ``internlm2-1.8b`` (2 layers, d = 256, f32) and the reduced
``xlstm-1.3b`` (one mLSTM + one sLSTM block, d = 256, f32) with the
reference's ``init_model`` weights carried across by
``interop.model_params``.  Logits and cache leaves to 1e-4 (f32 GEMMs
summed in another order through 2 layers)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop, utils
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

import _jax_serve_jits

CFG = get_reduced("internlm2-1.8b")
JCFG = jget_reduced("internlm2-1.8b")
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _shared_reference_jits():
    """Every reference engine of one kind reuses the first one's compiled
    programs (``tests/_jax_serve_jits.py``): the same programs on the same
    inputs, compiled once a module instead of once an engine."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_serve_jits.share(mp)
        yield


@pytest.fixture(scope="module")
def params():
    jp = JT.init_model(jax.random.key(7), JCFG)
    return jp, interop.model_params(jax.tree.map(np.asarray, jp))


@pytest.fixture
def rng():
    return np.random.default_rng(9)


@pytest.mark.parametrize("arch", JARCHS)
def test_configs_are_copies(arch):
    assert arch in ARCHS
    for mine, theirs in ((get_config(arch), jget_config(arch)),
                         (get_reduced(arch), jget_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.approx_params() == theirs.approx_params()


@pytest.mark.parametrize("arch", ["pixtral-12b", "hubert-xlarge"])
def test_unported_families_raise(arch):
    """The two frontend families, which raised before their port: built
    from the reference's weights, the reduced config's ``forward`` on
    ``make_batch``'s inputs (pixtral's patches ahead of its text,
    hubert's frame features) matches the reference's logits to 1e-4."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_batch
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp = JT.init_model(jax.random.key(8), jcfg)
    tp = interop.model_params(jax.tree.map(np.asarray, jp))
    batch = make_batch(cfg, InputShape("t", 20, 2, "prefill"), seed=8)
    jl, _ = JT.forward(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    tl, _ = TT.forward(tp, cfg, {k: torch.as_tensor(v) for k, v in
                                 batch.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "granite-moe-1b-a400m",
                                  "zamba2-7b"])
def test_ported_families_match_reference(arch):
    """The families item 16 added (two MoE stacks, one of them windowed,
    and zamba2's Mamba2 + shared attention): the reduced config's
    ``forward`` logits to 1e-4 and its aux loss to 1e-6."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp = JT.init_model(jax.random.key(5), jcfg)
    tp = interop.model_params(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, ja = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, ta = TT.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)


def test_layers_match_reference(rng):
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + 3
    np.testing.assert_allclose(
        TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 500.0).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0)),
        atol=1e-5)
    h = rng.normal(size=(4, 24)).astype(np.float32)
    sc = {"scale": rng.normal(size=(24,)).astype(np.float32),
          "bias": rng.normal(size=(24,)).astype(np.float32)}
    tsc = {k: torch.as_tensor(v) for k, v in sc.items()}
    for jf, tf in ((JL.rms_norm, TL.rms_norm), (JL.layer_norm, TL.layer_norm)):
        np.testing.assert_allclose(tf(tsc, torch.as_tensor(h)).numpy(),
                                   np.asarray(jf(sc, jnp.asarray(h))),
                                   atol=1e-5)
    for act in ("silu", "gelu"):
        jp = JL.init_mlp(jax.random.key(2), 24, 40, act)
        tp = interop.model_params(jax.tree.map(np.asarray, jp))
        np.testing.assert_allclose(
            TL.mlp(tp, torch.as_tensor(h), act).numpy(),
            np.asarray(JL.mlp(jp, jnp.asarray(h), act)), atol=1e-5)


def test_init_model_defaults_to_cuda():
    """Without a card the default device raises rather than running on
    the CPU, as ``make_env`` and ``init_train`` do; on the CPU when
    asked."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.init_model(0, CFG)
    p = TT.init_model(0, CFG, device="cpu")
    assert {x.device.type for x in utils.tree_leaves(p)} == {"cpu"}


def test_init_model_layout_matches_reference():
    """Same keys and shapes as the reference's tree (stacked layers)."""
    mine = TT.init_model(0, CFG, device="cpu")
    theirs = jax.eval_shape(lambda: JT.init_model(jax.random.key(0), JCFG))
    flat_m = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(mine)[0]}
    flat_t = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert flat_m == flat_t
    cast = TT.cast_params(mine, CFG.replace(dtype="bfloat16"))
    assert cast["layers"]["ln1"]["scale"].dtype == torch.float32
    assert cast["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert cast["embed"]["table"].dtype == torch.bfloat16


@pytest.mark.parametrize("window", [None, 6])
def test_forward_and_prefill_match_reference(params, rng, window):
    """Whole-sequence forward and prefill (the flash path, arange
    positions): logits to 1e-4, the filled dense caches to 1e-5."""
    jp, tp = params
    toks = rng.integers(0, CFG.vocab_size, (2, 13)).astype(np.int32)
    jl, _ = JT.forward(jp, JCFG, {"tokens": jnp.asarray(toks)},
                       window_override=window)
    tl, _ = TT.forward(tp, CFG, {"tokens": torch.as_tensor(toks)},
                       window_override=window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    jl, jc = JT.prefill(jp, JCFG, {"tokens": jnp.asarray(toks)}, 24, window)
    tl, tc = TT.prefill(tp, CFG, {"tokens": torch.as_tensor(toks)}, 24,
                        window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_dense_decode_steps_match_reference(params, rng):
    jp, tp = params
    toks = rng.integers(0, CFG.vocab_size, (2, 5)).astype(np.int32)
    _, jc = JT.prefill(jp, JCFG, {"tokens": jnp.asarray(toks)}, 12)
    _, tc = TT.prefill(tp, CFG, {"tokens": torch.as_tensor(toks)}, 12)
    for t in range(5, 9):
        tok = rng.integers(0, CFG.vocab_size, (2,)).astype(np.int32)
        pos = np.array([t, t], np.int32)
        jl, jc = JT.decode_step(jp, JCFG, jnp.asarray(tok), jnp.asarray(pos),
                                jc)
        tl, tc = TT.decode_step(tp, CFG, torch.as_tensor(tok),
                                torch.as_tensor(pos), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("kernel", [False, True])
def test_paged_chunks_and_decode_match_reference(params, rng, kernel):
    """``prefill_chunk`` twice (positions 0..6, then 7..11) into a paged
    pool through one slot's table row, then batched paged decode steps
    with a second, idle row, the port's decode read through the
    gather-decode kernel's plain version and the reference's through its
    Pallas kernel (interpret) when ``kernel``, else through its gather:
    logits to 1e-4, pool slot positions equal."""
    jp, tp = params
    P, npages, M = 4, 12, 5
    jc = JT.init_paged_cache(JCFG, 2, 20, None, jnp.float32, page_size=P,
                             num_pages=npages)
    tc = TT.init_paged_cache(CFG, 2, 20, None, torch.float32, page_size=P,
                             num_pages=npages)
    row = np.array([3, 7, 1, 9, -1], np.int32)
    toks = rng.integers(0, CFG.vocab_size, 12).astype(np.int32)
    for lo, hi in ((0, 7), (7, 12)):
        pos = np.arange(lo, hi, dtype=np.int32)
        jl, jc = JT.prefill_chunk(jp, JCFG, jnp.asarray(toks[lo:hi]),
                                  jnp.asarray(pos), jc, 0, jnp.asarray(row))
        tl, tc = TT.prefill_chunk(tp, CFG, torch.as_tensor(toks[lo:hi]),
                                  torch.as_tensor(pos), tc, 0,
                                  torch.as_tensor(row))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
    table = np.stack([row, np.full(M, -1, np.int32)])
    for t in range(12, 16):
        tok = np.array([toks[t % 12], 0], np.int32)
        pos = np.array([t, -1], np.int32)
        jl, jc = JT.decode_step(jp, JCFG, jnp.asarray(tok), jnp.asarray(pos),
                                jc, page_table=jnp.asarray(table),
                                paged_kernel=kernel)
        tl, tc = TT.decode_step(tp, CFG, torch.as_tensor(tok),
                                torch.as_tensor(pos), tc,
                                page_table=torch.as_tensor(table))
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   atol=LOGIT_TOL)
    np.testing.assert_array_equal(tc.slot_pos.numpy(),
                                  np.asarray(jc.slot_pos))


# ----------------------------------------------------------------- xlstm ----
XCFG = get_reduced("xlstm-1.3b")
JXCFG = jget_reduced("xlstm-1.3b")


@pytest.fixture(scope="module")
def xparams():
    jp = JT.init_model(jax.random.key(11), JXCFG)
    return jp, interop.model_params(jax.tree.map(np.asarray, jp))


def _tree_close(mine, theirs, tol=LOGIT_TOL):
    """Every leaf of the port's cache tree against the reference's."""
    theirs = interop.cache_tree(jax.tree.map(np.asarray, theirs))
    assert sorted(mine) == sorted(theirs)
    for key in theirs:
        assert type(mine[key]) is type(theirs[key])
        for f in theirs[key]._fields:
            a, b = getattr(mine[key], f), getattr(theirs[key], f)
            assert a.dtype == b.dtype and a.shape == b.shape, (key, f)
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol,
                                       atol=tol, err_msg=f"{key}.{f}")


def test_xlstm_layout_and_caches_match_reference():
    """``params["super"]`` keyed ``mlstm_0``/``slstm_1`` with a leading
    ``num_super`` dim, and the cache trees (f32 states, conv in the
    activation type), at the reduced and the full config."""
    mine = TT.init_model(0, XCFG, device="cpu")
    theirs = jax.eval_shape(lambda: JT.init_model(jax.random.key(0), JXCFG))
    flat = lambda t: {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(mine) == flat(theirs)
    assert TT.cast_params(mine, XCFG.replace(dtype="bfloat16"))[
        "super"]["slstm_1"]["r"].dtype == torch.float32
    for cfg, jcfg in ((XCFG, JXCFG), (get_config("xlstm-1.3b"),
                                      jget_config("xlstm-1.3b"))):
        jc = jax.eval_shape(lambda: JT.init_paged_cache(
            jcfg, 2, 16, page_size=4, num_pages=9))
        tc = TT.init_paged_cache(cfg, 2, 16, page_size=4, num_pages=9,
                                 device="meta")
        assert list(tc) == list(jc)
        for key in jc:
            for f in jc[key]._fields:
                a, b = getattr(tc[key], f), getattr(jc[key], f)
                assert tuple(a.shape) == b.shape
                assert str(a.dtype).split(".")[-1] == str(b.dtype), (key, f)


def test_xlstm_forward_prefill_decode_match_reference(xparams):
    """``forward`` and ``prefill`` of 16 tokens (one chunk), then decode
    steps with the second row idle (position -1: its state stays pinned):
    logits and every cache leaf to 1e-4."""
    jp, tp = xparams
    rng = np.random.default_rng(13)
    toks = rng.integers(0, XCFG.vocab_size, (2, 16)).astype(np.int32)
    jl, _ = JT.forward(jp, JXCFG, {"tokens": jnp.asarray(toks)})
    tl, _ = TT.forward(tp, XCFG, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    jl, jc = JT.prefill(jp, JXCFG, {"tokens": jnp.asarray(toks)}, 24)
    tl, tc = TT.prefill(tp, XCFG, {"tokens": torch.as_tensor(toks)}, 24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    _tree_close(tc, jc)
    idle = {k: [t[:, 1].clone() for t in n] for k, n in tc.items()}
    for t in range(16, 19):
        tok = np.array([toks[0, t - 16], 0], np.int32)
        pos = np.array([t, -1], np.int32)
        jl, jc = JT.decode_step(jp, JXCFG, jnp.asarray(tok),
                                jnp.asarray(pos), jc)
        tl, tc = TT.decode_step(tp, XCFG, torch.as_tensor(tok),
                                torch.as_tensor(pos), tc)
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   atol=LOGIT_TOL)
        _tree_close(tc, jc)
    for k, leaves in idle.items():
        for before, now in zip(leaves, tc[k]):
            assert torch.equal(before, now[:, 1]), k


def test_xlstm_prefill_chunk_with_slot_matches_reference(xparams):
    """Two prefill chunks (8 then 16 tokens: one and two mLSTM chunks) into
    slot 1 of a 3-slot paged tree whose other rows hold other states: the
    slot's state leaves and the logits match the reference to 1e-4, and
    rows 0 and 2 are untouched."""
    jp, tp = xparams
    rng = np.random.default_rng(17)
    jc = JT.init_paged_cache(JXCFG, 3, 32, None, jnp.float32, page_size=4,
                             num_pages=10)
    jc = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=x.shape).astype(np.float32) * 0.1), jc)
    tc = interop.cache_tree(jax.tree.map(np.asarray, jc))
    others = {k: [t[:, [0, 2]].clone() for t in n] for k, n in tc.items()}
    row = np.array([1, 2, 3, 4, 5, 6, -1, -1], np.int32)
    toks = rng.integers(0, XCFG.vocab_size, 24).astype(np.int32)
    for lo, hi in ((0, 8), (8, 24)):
        pos = np.arange(lo, hi, dtype=np.int32)
        jl, jc = JT.prefill_chunk(jp, JXCFG, jnp.asarray(toks[lo:hi]),
                                  jnp.asarray(pos), jc, 1, jnp.asarray(row))
        tl, tc = TT.prefill_chunk(tp, XCFG, torch.as_tensor(toks[lo:hi]),
                                  torch.as_tensor(pos), tc, 1,
                                  torch.as_tensor(row))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        _tree_close(tc, jc)
    for k, leaves in others.items():
        for before, now in zip(leaves, tc[k]):
            assert torch.equal(before, now[:, [0, 2]]), k


def test_xlstm_long_prompt_must_divide_the_chunk(xparams):
    """The reference's quirk, kept (ROADMAP queue C): a whole prompt longer
    than 256 tokens and not a multiple of 256 raises ``ValueError`` in
    both packages (``chunk=min(256, S)`` must divide S)."""
    jp, tp = xparams
    toks = np.zeros((1, 260), np.int32)
    with pytest.raises(ValueError, match="not divisible"):
        JT.forward(jp, JXCFG, {"tokens": jnp.asarray(toks)})
    with pytest.raises(ValueError, match="not divisible"):
        TT.forward(tp, XCFG, {"tokens": torch.as_tensor(toks)})


# ---------------------------------------------------------------- zamba2 ----
ZCFG = get_reduced("zamba2-7b")
JZCFG = jget_reduced("zamba2-7b")


@pytest.fixture(scope="module")
def zparams():
    jp = JT.init_model(jax.random.key(19), JZCFG)
    return jp, interop.model_params(jax.tree.map(np.asarray, jp))


def test_zamba2_layout_and_caches_match_reference():
    """``params["super"]`` holds ``mamba2_0`` stacked over ``num_super``
    and ``params["shared_attn"]`` the one shared block; the dense and the
    paged cache trees (f32 ``h``, conv in the activation type, KV caches
    or pools at the attention positions) match the reference's at the
    reduced and the full config; ``cast_params`` keeps Mamba2's
    ``A_log``, ``D`` and ``dt_bias`` in f32, as the reference reads them,
    and casts ``shared_attn``'s weights."""
    mine = TT.init_model(0, ZCFG, device="cpu")
    theirs = jax.eval_shape(lambda: JT.init_model(jax.random.key(0), JZCFG))
    flat = lambda t: {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(mine) == flat(theirs) and "shared_attn" in mine
    cast = TT.cast_params(mine, ZCFG.replace(dtype="bfloat16"))
    m = cast["super"]["mamba2_0"]
    assert {m[k].dtype for k in ("A_log", "D", "dt_bias")} == {torch.float32}
    assert m["w_in"].dtype == m["conv"]["w"].dtype == torch.bfloat16
    assert cast["shared_attn"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    for cfg, jcfg in ((ZCFG, JZCFG), (get_config("zamba2-7b"),
                                      jget_config("zamba2-7b"))):
        for paged in (False, True):
            if paged:
                jc = jax.eval_shape(lambda: JT.init_paged_cache(
                    jcfg, 2, 16, page_size=4, num_pages=9))
                tc = TT.init_paged_cache(cfg, 2, 16, page_size=4,
                                         num_pages=9, device="meta")
            else:
                jc = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 16))
                tc = TT.init_cache(cfg, 2, 16, device="meta")
            assert sorted(tc) == sorted(jc)
            for key in jc:
                assert type(tc[key]).__name__ == type(jc[key]).__name__
                for f in jc[key]._fields:
                    a, b = getattr(tc[key], f), getattr(jc[key], f)
                    assert tuple(a.shape) == b.shape, (key, f)
                    assert str(a.dtype).split(".")[-1] == str(b.dtype)
    assert TT.layer_windows(get_config("zamba2-7b")) == [TT.BIG_WINDOW] * 9
    assert TT.layer_windows(ZCFG, 8) == JT.layer_windows(JZCFG, 8) == [8]


def test_zamba2_forward_prefill_decode_match_reference(zparams):
    """``forward`` and ``prefill`` of 16 tokens (one Mamba2 chunk, the
    shared block on the flash path), then decode steps with the second
    row idle (position -1: its Mamba2 state stays pinned): logits and
    every cache leaf to 1e-4."""
    jp, tp = zparams
    rng = np.random.default_rng(23)
    toks = rng.integers(0, ZCFG.vocab_size, (2, 16)).astype(np.int32)
    jl, jc = JT.prefill(jp, JZCFG, {"tokens": jnp.asarray(toks)}, 24)
    tl, tc = TT.prefill(tp, ZCFG, {"tokens": torch.as_tensor(toks)}, 24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    _tree_close(tc, jc)
    idle = [t[:, 1].clone() for t in tc["mamba2_0"]]
    for t in range(16, 19):
        tok = np.array([toks[0, t - 16], 0], np.int32)
        pos = np.array([t, -1], np.int32)
        jl, jc = JT.decode_step(jp, JZCFG, jnp.asarray(tok),
                                jnp.asarray(pos), jc)
        tl, tc = TT.decode_step(tp, ZCFG, torch.as_tensor(tok),
                                torch.as_tensor(pos), tc)
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   atol=LOGIT_TOL)
        _tree_close(tc, jc)
    for before, now in zip(idle, tc["mamba2_0"]):
        assert torch.equal(before, now[:, 1])


def test_zamba2_prefill_chunk_with_slot_matches_reference(zparams):
    """Two prefill chunks (8 then 16 tokens) into slot 1 of a 3-slot paged
    tree whose other rows hold other Mamba2 states, the shared block
    writing its pool through the slot's table row: logits and every leaf
    to 1e-4 (pool pages and slot positions included), rows 0 and 2
    untouched."""
    jp, tp = zparams
    rng = np.random.default_rng(29)
    jc = JT.init_paged_cache(JZCFG, 3, 32, None, jnp.float32, page_size=4,
                             num_pages=10)
    jc["mamba2_0"] = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=x.shape).astype(np.float32) * 0.1), jc["mamba2_0"])
    tc = interop.cache_tree(jax.tree.map(np.asarray, jc))
    others = [t[:, [0, 2]].clone() for t in tc["mamba2_0"]]
    row = np.array([1, 2, 3, 4, 5, 6, -1, -1], np.int32)
    toks = rng.integers(0, ZCFG.vocab_size, 24).astype(np.int32)
    for lo, hi in ((0, 8), (8, 24)):
        pos = np.arange(lo, hi, dtype=np.int32)
        jl, jc = JT.prefill_chunk(jp, JZCFG, jnp.asarray(toks[lo:hi]),
                                  jnp.asarray(pos), jc, 1, jnp.asarray(row))
        tl, tc = TT.prefill_chunk(tp, ZCFG, torch.as_tensor(toks[lo:hi]),
                                  torch.as_tensor(pos), tc, 1,
                                  torch.as_tensor(row))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        _tree_close(tc, jc)
    for before, now in zip(others, tc["mamba2_0"]):
        assert torch.equal(before, now[:, [0, 2]])


def _zamba2_states_match(jeng, teng, tol=LOGIT_TOL):
    """Every leaf of the two engines' cache trees after a step: the Mamba2
    states of every slot to ``tol``; the shared block's pools by slot
    position (exact) and their k/v wherever a position is held (the trash
    page 0 takes idle rows' writes in whatever order each package lands
    them)."""
    theirs = interop.cache_tree(jax.tree.map(np.asarray, jeng._caches))
    for key, node in theirs.items():
        mine = teng._caches[key]
        if type(node).__name__ == "PagedKVCache":
            held = node.slot_pos.numpy() >= 0
            np.testing.assert_array_equal(mine.slot_pos.numpy(),
                                          node.slot_pos.numpy())
            held[:, 0] = False
            for f in ("k_pages", "v_pages"):
                np.testing.assert_allclose(
                    getattr(mine, f).numpy()[held],
                    getattr(node, f).numpy()[held], rtol=tol, atol=tol,
                    err_msg=f"{key}.{f}")
            continue
        for f in node._fields:
            np.testing.assert_allclose(
                getattr(mine, f).numpy(), getattr(node, f).numpy(),
                rtol=tol, atol=tol, err_msg=f"{key}.{f}")


@pytest.mark.parametrize("chunk", [0, 6])
def test_zamba2_engine_matches_reference(chunk):
    """The paged engine over the reduced zamba2 (one Mamba2 block and the
    shared attention block, d = 256, f32) against the reference's, whole-
    prompt or in 6-token chunks from the slot's carried state, staggered
    arrivals and more requests than slots: greedy tokens, page tables and
    free pages equal, every state leaf compared after every step (a
    reused slot's state reset, idle and still-prefilling rows pinned
    during decode); tokens equal the port's own oracle.  Prefix sharing
    is off for the patterned stack, as in the reference."""
    from test_torch_serve import _engines, _run_both
    jeng, teng = _engines(dataclasses.asdict(ZCFG), seed=31,
                          chunk_prefill=chunk, max_slots=3, max_seq=40)
    assert not teng._share and not jeng._share
    assert teng.cache_bytes == jeng._cache_bytes
    rng = np.random.default_rng(37)
    stream = [(rng.integers(0, 512, n), b) for n, b in
              ((14, 5), (5, 4), (20, 3), (6, 6), (13, 4), (4, 3), (19, 5))]
    treqs, toks = _run_both(jeng, teng, stream, waves=(3, 2),
                            each_step=_zamba2_states_match)
    for i in (0, 2):
        assert toks[i] == teng.oracle_generate(treqs[i])
