"""The port's paged serving engine on the two families whose attention
runs with a sliding window, against the JAX package's ``ServeEngine`` on
its Pallas decode route (interpret mode) on the CPU, weights carried
across by ``interop.model_params``:

- reduced gemma2-27b: even layers local (window 16), odd layers global,
  attention softcap 50 and final softcap 30;
- reduced mixtral-8x7b: every layer windowed at 16, 4 experts top-2.

Prompts of 20-40 tokens arrive in two waves and their budgets carry
decode past the window, so both prefill and decode mask keys.  Greedy
tokens, page tables and free-page counts equal the reference's after
every step (``test_torch_serve._run_both``), and the tokens equal the
port's own ``oracle_generate``.  Also: ``init_model(..., cast=True)``
draws the serving weights bit for bit as ``cast_params(init_model())``,
and a traced step (the dry run's fake tensors) counts each layer's
attention over its own window."""
import dataclasses

import numpy as np
import pytest
import torch

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import InputShape, get_reduced
from repro_torch.kernels import cost
from repro_torch.launch import hlo_analysis
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as T
from repro_torch.utils import tree_leaves

import _jax_serve_jits
from test_torch_serve import _engines, _run_both

ARCHS = ["gemma2-27b", "mixtral-8x7b"]


@pytest.fixture(autouse=True, scope="module")
def _shared_reference_jits():
    with pytest.MonkeyPatch.context() as mp:
        _jax_serve_jits.share(mp)
        yield


def _stream(cfg, seed, n=5):
    """``n`` prompts of 20-40 tokens, budgets of 6-14 greedy tokens."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(20, 41))),
             int(rng.integers(6, 15))) for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_windowed_engine_matches_reference(arch):
    cfg = get_reduced(arch)
    W = cfg.sliding_window
    assert W == 16
    windows = T.layer_windows(cfg)
    if cfg.local_global:
        assert windows[0] == W and windows[1] > 1000
        assert cfg.attn_softcap and cfg.final_softcap
    else:
        assert windows == [W] * cfg.num_layers and cfg.num_experts
    stream = _stream(cfg, 31)
    assert min(len(t) for t, _ in stream) > W
    jeng, teng = _engines(dataclasses.asdict(cfg), seed=5,
                          decode_kernel=True, max_slots=3, max_seq=64)
    treqs, toks = _run_both(jeng, teng, stream, waves=(2, 2))
    for i, r in enumerate(treqs):
        assert toks[i] == teng.oracle_generate(r)
    assert np.all(teng._table == -1)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_cast_at_draw_matches_cast_params(arch):
    cfg = get_reduced(arch).replace(dtype="bfloat16")
    want = T.cast_params(T.init_model(0, cfg, "cpu"), cfg)
    got = T.init_model(0, cfg, "cpu", cast=True)
    wl, gl = tree_leaves(want), tree_leaves(got)
    assert len(wl) == len(gl)
    assert {t.dtype for t in gl} == {torch.bfloat16, torch.float32}
    for w, g in zip(wl, gl):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_traced_prefill_counts_each_layers_window(arch):
    """The card's trace of a 2 x 64 prefill records, for each layer's
    flash call, the pairs its own window leaves visible: gemma2's local
    layers and every mixtral layer see 16 keys, gemma2's global layers
    all the causal ones."""
    cfg = get_reduced(arch)
    B, S = 2, 64
    fn, args = make_prefill_step(cfg, None, InputShape("p", S, B,
                                                       "prefill"))
    counts = hlo_analysis.trace(fn, args, "cuda")["counts"]
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    per = [cost.flash_attention(B, S, H, KH, hd, 4, True, w)[1]
           for w in T.layer_windows(cfg)]
    whole = cost.flash_attention(B, S, H, KH, hd, 4, True)[1]
    assert counts["kernel_calls"] == {"flash_attention": len(per)}
    assert counts["kernel_flops"]["flash_attention"] == sum(per)
    assert sum(per) < len(per) * whole
    # a window of 16 leaves 16 * 17 / 2 + 48 * 16 of the 64 * 65 / 2 pairs
    assert min(per) == whole * (136 + 768) // 2080


@pytest.mark.parametrize("window", [None, 9, 1000])
def test_traced_paged_decode_counts_the_pages_a_window_spans(window):
    """On fake tensors the paged decode cost takes each row's most: its
    whole table, or the pages ``window`` consecutive positions can span
    (9 positions over 4-slot pages: 3 of the 10) and that many keys."""
    B, H, KH, hd, P, M = 2, 4, 2, 8, 4, 10
    with FakeTensorMode():
        q = torch.empty((B, H, hd), dtype=torch.bfloat16)
        kp = torch.empty((B * M + 1, P, KH, hd), dtype=torch.bfloat16)
        sp = torch.empty((B * M + 1, P), dtype=torch.int32)
        table = torch.empty((B, M), dtype=torch.int32)
        pos = torch.empty((B,), dtype=torch.int32)
        nbytes, nops = cost.paged_attention(q, kp, kp, sp, table, pos,
                                            window)
    pages, keys = (3, 9) if window == 9 else (M, M * P)
    assert nops == B * keys * 4 * H * hd
    assert nbytes == 2 * B * H * hd * 2 + B * M * 4 + B * 4 + \
        B * pages * (2 * P * KH * hd * 2 + P * 4)
