"""The port's serving engine (``repro_torch/serve/engine.py``) against the
JAX package's ``ServeEngine`` on the CPU, with the reference's small
attention config from ``tests/test_serve_engine.py`` and the reduced
``internlm2-1.8b``, weights carried across by ``interop.model_params``.

Under the same request stream the two engines must emit the same greedy
tokens and hold the same page tables and free-page counts after every
step; the port must also equal its own ``oracle_generate``.  The launcher
runs on the CPU in a fresh process that never imports JAX."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _pick_tokens

import _jax_serve_jits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 64
SMALL = dict(name="d", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=V)


@pytest.fixture(autouse=True, scope="module")
def _shared_reference_jits():
    """Every reference engine of one kind reuses the first one's compiled
    programs (``tests/_jax_serve_jits.py``): the same programs on the same
    inputs, compiled once a module instead of once an engine."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_serve_jits.share(mp)
        yield


def _engines(cfg_kw=SMALL, seed=3, decode_kernel=False, **kw):
    """The reference engine and the port's from the same weights;
    ``decode_kernel`` picks the reference's paged decode route (the port
    always decodes through its gather-decode kernel)."""
    jcfg = JModelConfig(**cfg_kw)
    jp = JT.init_model(jax.random.key(seed), jcfg)
    tp = interop.model_params(jax.tree.map(np.asarray, jp))
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq", 40)
    return (JServeEngine(jcfg, jp, decode_kernel=decode_kernel, **kw),
            ServeEngine(ModelConfig(**cfg_kw), tp, device="cpu", **kw))


def _stream(seed, n, head_len=12, budgets=(6, 8, 3, 5, 4)):
    """Prompts of 3-20 tokens; every other one starts with a shared head,
    the rest are random."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, V, head_len)
    out = []
    for i in range(n):
        tail = rng.integers(0, V, int(rng.integers(3, 9)))
        toks = np.concatenate([head, tail]) if i % 2 == 0 else tail
        out.append((toks, budgets[i % len(budgets)]))
    return out


def _run_both(jeng, teng, stream, waves=(2, 2), each_step=None):
    """Submit in waves with two engine steps between them, then drain;
    page tables and free pages compared after every step, and
    ``each_step(jeng, teng)`` called after every step when given."""
    jreqs = [JRequest(tokens=t, max_new_tokens=b) for t, b in stream]
    treqs = [Request(tokens=t, max_new_tokens=b) for t, b in stream]
    jdone, tdone, steps = [], [], 0
    i = 0

    def step():
        jdone.extend(jeng.step())
        tdone.extend(teng.step())
        if teng.paged:
            np.testing.assert_array_equal(teng._table, jeng._table)
        assert teng.free_pages == jeng.free_pages
        assert teng.active_count == jeng.active_count
        if each_step is not None:
            each_step(jeng, teng)

    for w in waves:
        for _ in range(w):
            jeng.submit(jreqs[i])
            teng.submit(treqs[i])
            i += 1
        step()
        step()
    for r in range(i, len(stream)):
        jeng.submit(jreqs[r])
        teng.submit(treqs[r])
    while jeng.busy or teng.busy:
        step()
        steps += 1
        assert steps < 500
    jidx = {r.rid: n for n, r in enumerate(jreqs)}
    tidx = {r.rid: n for n, r in enumerate(treqs)}
    jt = {jidx[c.rid]: c.tokens for c in jdone}
    tt = {tidx[c.rid]: c.tokens for c in tdone}
    assert tt == jt and len(tt) == len(stream)
    return treqs, tt


def test_engine_matches_reference_kernel_chunked_windowed_shared():
    """The reference's ``decode_kernel=True``, ``chunk_prefill=3``,
    ``window_override=16`` and shared prompt heads (copy-on-write inside
    the 8-token block), staggered arrivals: tokens, page tables and free pages equal the
    reference engine's; tokens equal the port's own oracle."""
    jeng, teng = _engines(decode_kernel=True, window_override=16,
                          chunk_prefill=3, max_seq=48)
    treqs, toks = _run_both(jeng, teng, _stream(21, 6))
    assert teng._index.pages(), "no prompt block was shared"
    for i, r in enumerate(treqs):
        assert toks[i] == teng.oracle_generate(r)
    assert np.all(teng._table == -1)


@pytest.mark.parametrize("kw", [dict(), dict(batch_prefill=False),
                                dict(share_prefix=False, max_slots=3),
                                dict(num_pages=10, max_slots=3)])
def test_engine_matches_reference_configurations(kw):
    """Whole-prompt batched prefill, one prefill a prompt, no sharing,
    and an oversubscribed pool (admission blocks on pages): the same
    equalities as above."""
    jeng, teng = _engines(**kw)
    _run_both(jeng, teng, _stream(23, 5), waves=(3,))


def test_fault_hook_and_take_inflight_release_everything():
    """The fault seam kills the engine mid-decode (``dead``, the exception
    tagged with the engine); ``take_inflight`` and ``take_queue`` hand
    back every request and return every page."""
    _, teng = _engines(max_slots=2)
    reqs = [Request(tokens=t, max_new_tokens=b)
            for t, b in _stream(29, 4, budgets=(8,))]
    for r in reqs:
        teng.submit(r)
    teng.step()
    assert teng.active_count == 2 and teng.free_pages < teng.total_pages

    def boom(eng):
        raise RuntimeError("injected")
    teng.fault_hook = boom
    with pytest.raises(RuntimeError, match="injected") as exc:
        teng.step()
    assert teng.dead and exc.value.engine is teng
    back = teng.take_inflight() + teng.take_queue()
    assert sorted(r.rid for r in back) == sorted(r.rid for r in reqs)
    assert np.all(teng._table == -1) and teng.active_count == 0
    # pages still held are prefix-index entries only
    held = set(teng._index.pages())
    assert all(teng._pool.ref[p] == teng._index.entry_count(p)
               for p in held)
    assert teng.free_pages + len(held) == teng.total_pages
    with pytest.raises(RuntimeError, match="dead"):
        teng.fault_hook = None
        teng.step()


def test_dense_engine_matches_reference():
    jeng, teng = _engines(paged=False)
    treqs, toks = _run_both(jeng, teng, _stream(25, 4))
    assert teng.total_pages == 0 and teng.free_pages == 0
    for i, r in enumerate(treqs):
        assert toks[i] == teng.oracle_generate(r)


def test_reduced_internlm2_engine_matches_reference():
    """The slice's model at its reduced size (2 layers, d = 256, f32),
    paged with the reference on its decode kernel, and chunked prefill."""
    cfg = dataclasses.asdict(get_reduced("internlm2-1.8b"))
    jeng, teng = _engines(cfg, seed=4, decode_kernel=True, chunk_prefill=8,
                          max_seq=40)
    rng = np.random.default_rng(27)
    stream = [(rng.integers(0, 512, n), b)
              for n, b in ((14, 6), (5, 4), (20, 3), (9, 5))]
    _run_both(jeng, teng, stream)


def _states_match(jeng, teng, tol=1e-4):
    """Every recurrent-state leaf of the two engines' cache trees, all
    slots, to ``tol`` (f32 sums in another order through 2 blocks)."""
    theirs = interop.cache_tree(jax.tree.map(np.asarray, jeng._caches))
    for key, node in theirs.items():
        for f in node._fields:
            np.testing.assert_allclose(
                getattr(teng._caches[key], f).numpy(),
                getattr(node, f).numpy(), rtol=tol, atol=tol,
                err_msg=f"{key}.{f}")


XLSTM = dataclasses.asdict(get_reduced("xlstm-1.3b"))


def test_reduced_xlstm_engine_matches_reference():
    """The slice's model at its reduced size (one mLSTM + one sLSTM block,
    d = 256, f32), paged (its tree holds no paged node: the pool is
    bookkeeping only), chunked prefill of 6-token chunks (merged 7-token
    tails), staggered arrivals and more requests than slots, so slots are
    reused: greedy tokens, page tables and free-page counts equal the
    reference engine's, and every state leaf of every slot matches it to
    1e-4 after every step (a reused slot's state reset, idle and
    still-prefilling rows frozen during decode, as the reference does).
    Prefix sharing is off for the patterned stack, as in the reference."""
    jeng, teng = _engines(XLSTM, seed=6, chunk_prefill=6, max_slots=3,
                          max_seq=40)
    assert not teng._share and not jeng._share
    assert teng.cache_bytes == jeng._cache_bytes
    rng = np.random.default_rng(31)
    stream = [(rng.integers(0, 512, n), b) for n, b in
              ((14, 5), (5, 4), (20, 3), (6, 6), (13, 4), (4, 3), (19, 5))]
    treqs, toks = _run_both(jeng, teng, stream, waves=(3, 2),
                            each_step=_states_match)
    for i in (0, 2):
        assert toks[i] == teng.oracle_generate(treqs[i])


def test_xlstm_engine_resets_reused_slots_and_freezes_idle_rows(
        monkeypatch):
    """Two requests served to the end leave their final states in slots 0
    and 1.  Idle slot 1 keeps its state bit for bit across decode steps of
    slot 0.  A chunked prefill admitted into reused slot 1 starts from a
    zeroed row, so its state after the first chunk equals the same chunk's
    in a fresh engine; with ``_reset_row`` disabled it does not."""
    cfg = ModelConfig(**XLSTM)
    tp = interop.model_params(jax.tree.map(np.asarray, JT.init_model(
        jax.random.key(8), JModelConfig(**XLSTM))))
    rng = np.random.default_rng(33)
    earlier = [Request(tokens=rng.integers(0, 512, n), max_new_tokens=3)
               for n in (7, 6)]
    other = Request(tokens=rng.integers(0, 512, 5), max_new_tokens=6)
    prompt = rng.integers(0, 512, 11)

    def row_after_first_chunk(eng):
        eng.submit(Request(tokens=prompt, max_new_tokens=2))
        eng.step()
        slot = next(i for i, s in enumerate(eng._slots)
                    if s is not None and s.prefilling)
        return [t[:, slot].clone() for n in eng._caches.values() for t in n]

    fresh = ServeEngine(cfg, tp, device="cpu", max_slots=2, max_seq=40,
                        chunk_prefill=4)
    want = row_after_first_chunk(fresh)
    for reset in (True, False):
        eng = ServeEngine(cfg, tp, device="cpu", max_slots=2, max_seq=40,
                          chunk_prefill=4)
        if not reset:
            monkeypatch.setattr(eng, "_reset_row", lambda slot: None)
        eng.serve(earlier)                     # slots 0, 1 hold states
        eng.submit(other)
        eng.step()                             # other decodes in slot 0
        dirty = [t[:, 1].clone() for n in eng._caches.values() for t in n]
        eng.step()
        eng.step()
        assert all(torch.equal(a, t[:, 1]) for a, t in zip(
            dirty, [t for n in eng._caches.values() for t in n]))
        got = row_after_first_chunk(eng)       # admitted into slot 1
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        assert same == reset


def test_sampling_is_batch_composition_independent():
    """A sampled request draws the same tokens alone (oracle) or batched
    with strangers, and the draw depends on (seed, position) only."""
    _, teng = _engines(max_slots=3)
    req = dict(tokens=np.arange(6), max_new_tokens=6, temperature=0.8,
               seed=42)
    oracle = teng.oracle_generate(Request(**req))
    rng = np.random.default_rng(12)
    done = teng.serve([Request(tokens=rng.integers(0, V, 5)),
                       Request(**req),
                       Request(tokens=rng.integers(0, V, 7))])
    assert [c.tokens for c in done if c.request.temperature > 0] == [oracle]
    logits = torch.zeros((3, V))
    a = _pick_tokens(logits, np.array([4, 4, 5], np.int32),
                     np.array([1, 1, 1], np.int32),
                     np.array([1.0, 1.0, 1.0], np.float32))
    assert a[0] == a[1]
    draws = {int(_pick_tokens(logits[:1], np.array([p], np.int32),
                              np.array([7], np.int32),
                              np.array([1.0], np.float32))[0])
             for p in range(40)}
    assert len(draws) > 10                 # uniform logits: spread draws
    greedy = _pick_tokens(torch.eye(3, V), np.zeros(3, np.int32),
                          np.zeros(3, np.int32), np.zeros(3, np.float32))
    assert greedy.tolist() == [0, 1, 2] and greedy.dtype == torch.int32


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    tp = interop.model_params(jax.tree.map(
        np.asarray, JT.init_model(jax.random.key(0), JModelConfig(**SMALL))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(ModelConfig(**SMALL), tp)


def test_serve_launcher_runs_without_jax():
    """``python -m repro_torch.launch.serve --device cpu`` end to end in a
    fresh process: the port's serving modules never import JAX."""
    code = ("import sys; from repro_torch.launch.serve import main; "
            "done = main(['--device', 'cpu', '--batch', '3', "
            "'--prompt-len', '12', '--gen', '5']); "
            "assert len(done) == 3 and all(len(c.tokens) == 5 for c in done)"
            "; assert 'jax' not in sys.modules, 'jax was imported'; "
            "print('NO_JAX_OK')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "NO_JAX_OK" in out.stdout and "decode:" in out.stdout


def test_xlstm_launcher_runs_without_jax():
    """``--arch xlstm-1.3b`` (reduced) on the CPU in a fresh process."""
    code = ("import sys; from repro_torch.launch.serve import main; "
            "done = main(['--arch', 'xlstm-1.3b', '--device', 'cpu', "
            "'--batch', '2', '--prompt-len', '8', '--gen', '3']); "
            "assert len(done) == 2 and all(len(c.tokens) == 3 for c in done)"
            "; assert 'jax' not in sys.modules, 'jax was imported'; "
            "print('NO_JAX_OK')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "NO_JAX_OK" in out.stdout and "arch=xlstm-1.3b" in out.stdout
