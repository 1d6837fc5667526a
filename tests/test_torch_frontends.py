"""The vision and audio frontends of the port's model stack
(``repro_torch/models/transformer.py``) and the serving paths that reach
them, against the JAX package on the CPU at the reduced ``pixtral-12b``
(8 patch embeddings ahead of the text) and ``hubert-xlarge``
(bidirectional, encoder-only), plus gemma2's per-layer decode caches.
Weights come from the reference's ``init_model`` through
``interop.model_params``, inputs from ``make_batch`` (numpy).  Logits to
1e-4, caches to 1e-5 (f32 GEMMs summed in other orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.configs.base import InputShape
from repro_torch.data import make_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.disagg import PrefillEngine

import _jax_serve_jits

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _shared_reference_jits():
    with pytest.MonkeyPatch.context() as mp:
        _jax_serve_jits.share(mp)
        yield


def _setup(arch, seed=2, S=24, B=2):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp = JT.init_model(jax.random.key(seed), jcfg)
    tp = interop.model_params(jax.tree.map(np.asarray, jp))
    batch = make_batch(cfg, InputShape("t", S, B, "prefill"), seed=seed)
    return jcfg, cfg, jp, tp, batch


def _both(batch, drop=()):
    return ({k: jnp.asarray(v) for k, v in batch.items() if k not in drop},
            {k: torch.as_tensor(v) for k, v in batch.items()
             if k not in drop})


def _caches_close(tc, jc, tol=CACHE_TOL):
    tn = interop.to_numpy(tc)
    for a, b in zip(jax.tree.leaves(tn), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a, np.asarray(b), atol=tol)


@pytest.mark.parametrize("arch,drop", [("pixtral-12b", ()),
                                       ("pixtral-12b", ("patches",)),
                                       ("hubert-xlarge", ())])
def test_forward_and_prefill_match_reference(arch, drop):
    """``forward`` and ``prefill`` (last logits and every cache leaf):
    pixtral with its patches ahead of the text and text only, hubert from
    its frame features through the bidirectional stack and ``head``."""
    jcfg, cfg, jp, tp, batch = _setup(arch)
    jb, tb = _both(batch, drop)
    jl, _ = JT.forward(jp, jcfg, jb)
    tl, _ = TT.forward(tp, cfg, tb)
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    jlast, jc = JT.prefill(jp, jcfg, jb, 40)
    tlast, tc = TT.prefill(tp, cfg, tb, 40)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                               atol=LOGIT_TOL)
    _caches_close(tc, jc)


def test_pixtral_decode_after_patch_prefill_matches_reference():
    """Three greedy decode steps on the cache a patch prefill filled,
    positions continuing after the patches and text."""
    jcfg, cfg, jp, tp, batch = _setup("pixtral-12b")
    jb, tb = _both(batch)
    jlast, jc = JT.prefill(jp, jcfg, jb, 48)
    tlast, tc = TT.prefill(tp, cfg, tb, 48)
    S = cfg.num_patches + batch["tokens"].shape[1]
    for i in range(3):
        tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)
        pos = np.full((2,), S + i, np.int32)
        jlast, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok),
                                   jnp.asarray(pos), jc)
        tlast, tc = TT.decode_step(tp, cfg, torch.as_tensor(tok),
                                   torch.as_tensor(pos), tc)
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   atol=LOGIT_TOL)
    _caches_close(tc, jc)


def test_hubert_refuses_decode_and_serving():
    """The encoder-only model: ``decode_step`` raises the reference's
    ValueError in both packages, the engines refuse it, and the serving
    launcher exits."""
    jcfg, cfg, jp, tp, _ = _setup("hubert-xlarge")
    tok, pos = np.zeros((2,), np.int32), np.zeros((2,), np.int32)
    with pytest.raises(ValueError, match="encoder-only"):
        JT.decode_step(jp, jcfg, jnp.asarray(tok), jnp.asarray(pos), None)
    with pytest.raises(ValueError, match="encoder-only model has no decode"):
        TT.decode_step(tp, cfg, torch.as_tensor(tok), torch.as_tensor(pos),
                       None)
    for make in (ServeEngine, PrefillEngine):
        with pytest.raises(ValueError, match="encoder-only"):
            make(cfg, tp, device="cpu")
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_pixtral_engine_with_patches_matches_reference():
    """A paged engine serving pixtral requests with their patches in
    ``Request.extras`` (whole-prompt admission one at a time, no prefix
    sharing) beside text-only ones: greedy tokens, page tables and free
    pages equal to the JAX engine's after every step."""
    jcfg, cfg, jp, tp, _ = _setup("pixtral-12b", seed=4)
    rng = np.random.default_rng(5)
    kw = dict(max_slots=2, max_seq=48)
    jeng = JServeEngine(jcfg, jp, decode_kernel=True, **kw)
    teng = ServeEngine(cfg, tp, device="cpu", **kw)
    stream = []
    for i, (n, gen) in enumerate(((12, 5), (7, 4), (10, 6), (5, 3))):
        toks = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        extras = None if i == 1 else {"patches": rng.standard_normal(
            (cfg.num_patches, cfg.frontend_feat_dim)).astype(np.float32)}
        stream.append((toks, gen, extras))
    jreqs = [JRequest(tokens=t, max_new_tokens=g, extras=e)
             for t, g, e in stream]
    treqs = [Request(tokens=t, max_new_tokens=g, extras=e)
             for t, g, e in stream]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jdone, tdone, steps = [], [], 0
    while jeng.busy or teng.busy:
        jdone.extend(jeng.step())
        tdone.extend(teng.step())
        np.testing.assert_array_equal(teng._table, jeng._table)
        assert teng.free_pages == jeng.free_pages
        steps += 1
        assert steps < 200
    jt = {[r.rid for r in jreqs].index(c.rid): c.tokens for c in jdone}
    tt = {[r.rid for r in treqs].index(c.rid): c.tokens for c in tdone}
    assert tt == jt and len(tt) == 4
    assert all(len(tt[i]) == g for i, (_, g, _) in enumerate(stream))


def test_pixtral_serve_launcher_sends_patches(capsys):
    """``launch/serve.py`` on pixtral: every request carries its patches,
    and the printed prompt counts them."""
    done = tserve.main(["--arch", "pixtral-12b", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    assert len(done) == 2 and all(len(c.tokens) == 3 for c in done)
    assert "prompt=20" in capsys.readouterr().out


def test_gemma2_per_layer_decode_matches_reference():
    """gemma2's local/global stack with per-layer caches (each local layer
    a ring of its window, each global one the full depth): prefill fills
    the list, then four decode steps (the reference's unrolled one) cross
    the window; logits to 1e-4 and every layer's cache to 1e-5."""
    jcfg, cfg = jget_reduced("gemma2-27b"), get_reduced("gemma2-27b")
    jp = JT.init_model(jax.random.key(6), jcfg)
    tp = interop.model_params(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 14)).astype(np.int32)
    jlast, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 32,
                           per_layer_cache=True)
    tlast, tc = TT.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)}, 32,
                           per_layer_cache=True)
    assert isinstance(tc, list) and len(tc) == cfg.num_layers
    assert [c.k.shape[1] for c in tc] == [c.k.shape[1] for c in jc] \
        == [cfg.sliding_window, 32]
    step = jax.jit(lambda p, t, q, c: JT.decode_step(p, jcfg, t, q, c,
                                                      unroll=True))
    for i in range(4):
        tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)
        pos = np.full((2,), 14 + i, np.int32)
        jlast, jc = step(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        tlast, tc = TT.decode_step(tp, cfg, torch.as_tensor(tok),
                                   torch.as_tensor(pos), tc)
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   atol=LOGIT_TOL)
    _caches_close(tc, jc)


def test_frontend_params_cross_packages():
    """``init_model``'s frontend leaves (``frontend_proj`` and ``head``
    without ``embed``; ``patch_proj`` beside ``embed``) have the
    reference's keys and shapes, and ``interop.model_params`` carries
    them across unchanged."""
    for arch, has, lacks in (("hubert-xlarge", ("frontend_proj", "head"),
                              ("embed", "unembed")),
                             ("pixtral-12b", ("patch_proj", "embed"),
                              ("head",))):
        cfg = get_reduced(arch)
        mine = TT.init_model(0, cfg, device="cpu")
        theirs = jax.eval_shape(lambda: JT.init_model(jax.random.key(0),
                                                      jget_reduced(arch)))
        assert all(k in mine for k in has) and not any(k in mine
                                                       for k in lacks)
        shapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                  jax.tree_util.tree_flatten_with_path(theirs)[0]}
        assert shapes == {jax.tree_util.keystr(k): tuple(v.shape)
                          for k, v in jax.tree_util.tree_flatten_with_path(
                              mine)[0]}
        carried = interop.model_params(interop.to_numpy(mine))
        for k in has:
            for a, b in zip(jax.tree.leaves(interop.to_numpy(carried[k])),
                            jax.tree.leaves(interop.to_numpy(mine[k]))):
                np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(get_reduced("hubert-xlarge"))["causal"] is False


def test_prefill_and_serve_step_builders_match_reference():
    """``make_prefill_step`` and ``make_serve_step`` (no mesh: one device)
    at the reduced gemma2 with per-layer caches: their example args have
    the reference builders' shapes, and a prefill then two decode steps
    through the built functions match the reference's ``prefill`` and
    unrolled ``decode_step``."""
    from repro.launch import steps as JS
    from repro_torch.launch import steps as TS
    jcfg, cfg = jget_reduced("gemma2-27b"), get_reduced("gemma2-27b")
    jp = JT.init_model(jax.random.key(9), jcfg)
    tp = interop.model_params(jax.tree.map(np.asarray, jp))
    pshape = InputShape("p", 24, 2, "prefill")
    dshape = InputShape("d", 24, 2, "decode")
    prefill, (psds, bsds) = TS.make_prefill_step(cfg, None, pshape)
    serve, (_, csds, tsds, qsds) = TS.make_serve_step(
        cfg, None, dshape, per_layer_cache=True)
    assert prefill.specs is None and serve.specs is None
    jcache = jax.eval_shape(lambda: JT.init_cache(
        jcfg, 2, 24, per_layer=True))
    assert [tuple(c.k.shape) for c in csds] == \
        [tuple(c.k.shape) for c in jcache]
    assert tuple(bsds["tokens"].shape) == (2, 24)
    assert tuple(tsds.shape) == tuple(qsds.shape) == (2,)
    assert {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(psds)[0]} == \
        {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
         jax.tree_util.tree_flatten_with_path(
             JS.abstract_train_state(jcfg)[0])[0]}
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jlast, _ = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 24)
    tlast, _ = prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                               atol=LOGIT_TOL)
    jlast, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 24,
                           per_layer_cache=True)
    _, tc = TT.prefill(tp, cfg, {"tokens": torch.as_tensor(toks)}, 24,
                       per_layer_cache=True)
    for i in range(2):
        tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)
        pos = np.full((2,), 12 + i, np.int32)
        jlast, jc = JT.decode_step(jp, jcfg, jnp.asarray(tok),
                                   jnp.asarray(pos), jc, unroll=True)
        tlast, tc = serve(tp, tc, torch.as_tensor(tok), torch.as_tensor(pos))
        assert tlast.dtype == torch.float32
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   atol=LOGIT_TOL)
    _caches_close(tc, jc)
