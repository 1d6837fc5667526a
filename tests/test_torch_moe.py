"""The port's mixture-of-experts layer (``repro_torch/models/moe.py``), the
MoE stack of ``models/transformer.py`` and the serving engine's MoE rules
against the JAX package on the CPU, at f32.

Exact: routing slots and their validity (ties included: both packages put
the lower expert index first), greedy tokens, page tables.  Floats: gates
to 1e-6 (one softmax and a division), ``moe_apply``'s output to 1e-5 and
its aux loss to 1e-6 (f32 GEMMs and sums in another order), logits of the
reduced granite-moe-1b-a400m (2 layers, d = 256, 4 experts top-2) to 1e-4
and its prefill caches to 1e-5, the gates of
``tests/test_torch_transformer.py``.  Weights come from the reference's
``init_moe``/``init_model``, carried across by ``interop.model_params``;
inputs from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serve import ServeEngine as JServeEngine
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import ServeEngine
import _jax_serve_jits
from test_torch_serve import _engines, _run_both

ARCH = "granite-moe-1b-a400m"
CFG, JCFG = get_reduced(ARCH), jget_reduced(ARCH)
GRANITE = dataclasses.asdict(CFG)
D, F, E = 16, 24, 8


@pytest.fixture(autouse=True, scope="module")
def _shared_reference_jits():
    """Every reference engine of one kind reuses the first one's compiled
    programs (``tests/_jax_serve_jits.py``): the same programs on the same
    inputs, compiled once a module instead of once an engine."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_serve_jits.share(mp)
        yield


def _moe_params(seed=0, d=D, f=F, e=E):
    jp = JM.init_moe(jax.random.key(seed), d, f, e)
    return jp, interop.model_params(jax.tree.map(np.asarray, jp))


def _route_both(x, logits, k, cap, e):
    j = JM._route_group(jnp.asarray(x), jnp.asarray(logits), k, cap, e)
    t = TM._route_group(torch.as_tensor(x), torch.as_tensor(logits), k, cap,
                        e)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=0,
                               atol=1e-6)
    return t


@pytest.mark.parametrize("case", ["random", "ties", "drops"])
def test_route_group_matches_reference(case):
    """Random logits with room for every assignment; logits on a coarse
    grid (many exact ties, several at the top-k boundary), k = 4 of 8;
    and a capacity of 3 that drops later tokens: slot and valid exact,
    gate 1e-6."""
    rng = np.random.default_rng({"random": 1, "ties": 2, "drops": 3}[case])
    S = 32
    x = rng.normal(size=(S, D)).astype(np.float32)
    logits = rng.normal(size=(S, E)).astype(np.float32)
    k, cap = 2, 64
    if case == "ties":
        logits = np.round(logits * 2) / 2
        k = 4
        top = np.sort(logits, axis=1)[:, ::-1]
        assert (top[:, k - 1] == top[:, k]).sum() >= 4
    if case == "drops":
        cap = 3
    slot, _, valid = _route_both(x, logits, k, cap, E)
    assert bool(valid.all()) == (case != "drops")


def test_top_k_breaks_ties_by_lower_index():
    """All-equal logits pick experts 0..k-1 in order, as
    ``jax.lax.top_k``; a tie straddling the boundary keeps the lower one."""
    x = np.zeros((2, D), np.float32)
    logits = np.array([[0.0] * E, [1, 0, 2, 2, 0, 2, 0, 0]], np.float32)
    slot, _, _ = _route_both(x, logits, 3, 10, E)
    assert (slot[0] // 10).tolist() == [0, 1, 2]
    assert (slot[1] // 10).tolist() == [2, 3, 5]


def test_router_respects_capacity_and_gates_sum_to_one():
    rng = np.random.default_rng(4)
    S, e, k, cap = 32, 4, 2, 5
    x = rng.normal(size=(S, 8)).astype(np.float32)
    slot, gate, valid = TM._route_group(
        torch.as_tensor(x), torch.as_tensor(rng.normal(size=(S, e))
                                            .astype(np.float32)), k, cap, e)
    flat = slot.reshape(-1).numpy()
    kept = flat[flat < e * cap]
    assert len(set(kept.tolist())) == len(kept)
    for i in range(e):
        assert ((kept >= i * cap) & (kept < (i + 1) * cap)).sum() <= cap
    np.testing.assert_allclose(gate.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_token_major_priority_drops_late_tokens():
    S, e, k, cap = 8, 2, 1, 2
    x = torch.ones((S, 4))
    logits = torch.stack([torch.ones(S), torch.zeros(S)], -1)
    _, _, valid = TM._route_group(x, logits, k, cap, e)
    v = valid[:, 0].numpy()
    assert v[:cap].all() and not v[cap:].any()


@pytest.mark.parametrize("S,R,cf", [(12, 0, 1.25), (12, 4, 1.25),
                                    (14, 4, 1.25), (12, 0, 0.5)])
def test_moe_apply_matches_reference(S, R, cf):
    """Per-row routing, 4-token routing blocks, blocks with a padded tail
    (S % R != 0), and a capacity factor that drops assignments: out 1e-5,
    aux 1e-6."""
    jp, tp = _moe_params(1)
    x = np.random.default_rng(S + R).normal(size=(3, S, D)).astype(
        np.float32)
    jo, ja = JM.moe_apply(jp, jnp.asarray(x), num_experts=E, top_k=2,
                          capacity_factor=cf, route_block=R)
    to, ta = TM.moe_apply(tp, torch.as_tensor(x), num_experts=E, top_k=2,
                          capacity_factor=cf, route_block=R)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)
    assert ta.dtype == torch.float32


def test_moe_no_drop_equals_dense_mixture():
    """With unlimited capacity the scatter dispatch equals the dense
    'every expert, mixed by gate' oracle (the reference's property)."""
    B, S, k = 2, 8, 2
    _, p = _moe_params(4, 16, 32, 4)
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(B, S, 16))
                        .astype(np.float32))
    out, aux = TM.moe_apply(p, x, num_experts=4, top_k=k,
                            capacity_factor=100.0)
    gate_all = torch.softmax(x @ p["router"], dim=-1)
    topg, tope = TM._top_k(gate_all, k)
    topg = topg / topg.sum(-1, keepdim=True)
    h = torch.einsum("bsd,edf->besf", x, p["wi"])
    g = torch.einsum("bsd,edf->besf", x, p["wg"])
    y_e = torch.einsum("besf,efd->besd", torch.nn.functional.silu(g) * h,
                       p["wo"])
    mix = torch.zeros_like(x)
    for i in range(k):
        idx = tope[..., i][:, None, :, None].expand(B, 1, S, 16)
        mix = mix + topg[..., i][..., None] * torch.gather(y_e, 1, idx)[:, 0]
    np.testing.assert_allclose(out.numpy(), mix.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert float(aux) >= 0.0


def test_aux_loss_uniform_router_is_minimal():
    """A uniform router's load-balance loss is the coefficient."""
    _, p = _moe_params(6, 16, 16, 4)
    p["router"] = torch.zeros_like(p["router"])
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(2, 64, 16))
                        .astype(np.float32))
    _, aux = TM.moe_apply(p, x, num_experts=4, top_k=2, aux_coef=1.0)
    np.testing.assert_allclose(float(aux), 1.0, rtol=1e-4)


def test_sharding_hooks_are_identities():
    """The reference's sharding hooks keep their signatures and do
    nothing on one device."""
    assert TM.set_moe_sharding(("data",), "model") is None
    x = torch.ones(2, 3, 4)
    assert TM._constrain(x, None, "model") is x


# ------------------------------------------------------- granite-moe stack --
@pytest.fixture(scope="module")
def granite():
    jp = JT.init_model(jax.random.key(21), JCFG)
    return jp, interop.model_params(jax.tree.map(np.asarray, jp))


def test_granite_layout_and_cast_match_reference(granite):
    """``lp["moe"]`` in place of ``lp["mlp"]`` with the expert dim stacked
    under the layer dim, as the reference's tree; ``cast_params`` casts
    the router and every expert weight to the activation type and leaves
    only the norm scales in f32."""
    jp, _ = granite
    mine = TT.init_model(0, CFG, device="cpu")
    flat = lambda t: {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(mine) == flat(jax.eval_shape(lambda: jp))
    cast = TT.cast_params(mine, CFG.replace(dtype="bfloat16"))
    for name, leaf in jax.tree_util.tree_flatten_with_path(cast)[0]:
        key = jax.tree_util.keystr(name)
        want = torch.float32 if key.endswith("['scale']") else torch.bfloat16
        assert leaf.dtype == want, key
    assert set(cast["layers"]["moe"]) == {"router", "wi", "wg", "wo"}


def test_granite_forward_prefill_decode_match_reference(granite):
    """``forward`` (logits and the summed aux), ``prefill`` of 13 tokens
    (logits 1e-4, the filled caches 1e-5), then three dense decode steps
    (logits 1e-4)."""
    jp, tp = granite
    rng = np.random.default_rng(22)
    toks = rng.integers(0, CFG.vocab_size, (2, 13)).astype(np.int32)
    jl, ja = JT.forward(jp, JCFG, {"tokens": jnp.asarray(toks)})
    tl, ta = TT.forward(tp, CFG, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)
    assert float(ta) > 0.0
    jl, jc = JT.prefill(jp, JCFG, {"tokens": jnp.asarray(toks)}, 20)
    tl, tc = TT.prefill(tp, CFG, {"tokens": torch.as_tensor(toks)}, 20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    for t in range(13, 16):
        tok = rng.integers(0, CFG.vocab_size, (2,)).astype(np.int32)
        pos = np.array([t, t], np.int32)
        jl, jc = JT.decode_step(jp, JCFG, jnp.asarray(tok), jnp.asarray(pos),
                                jc)
        tl, tc = TT.decode_step(tp, CFG, torch.as_tensor(tok),
                                torch.as_tensor(pos), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def _granite_stream(seed, lens, budgets=(5, 4, 6)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab_size, n), budgets[i % len(budgets)])
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("mode", ["whole", "batched", "chunked"])
def test_granite_engine_matches_reference(mode):
    """The paged engine against the reference's: one whole-prompt prefill
    a request (``batch_prefill=False``), same-length prompts batched into
    one dispatch, and chunked prefill with ``moe_route_block`` 4 set by
    ``cfg.replace`` (the 6-token chunk rounds up to 8 in both): greedy
    tokens, page tables and free pages equal after every step; prefix
    sharing off for MoE, as in the reference."""
    cfg, kw = GRANITE, {}
    if mode == "whole":
        kw["batch_prefill"] = False
    if mode == "chunked":
        cfg = dict(GRANITE, moe_route_block=4)
        kw["chunk_prefill"] = 6
    jeng, teng = _engines(cfg, seed=23, max_slots=3, max_seq=40, **kw)
    assert not teng._share and not jeng._share
    assert teng.chunk_prefill == jeng.chunk_prefill
    if mode == "chunked":
        assert teng.chunk_prefill == 8
    lens = (9, 9, 9, 14, 5) if mode == "batched" else (14, 5, 20, 9, 11)
    treqs, toks = _run_both(jeng, teng, _granite_stream(24, lens),
                            waves=(3, 1))
    for i in (0, 2):
        assert toks[i] == teng.oracle_generate(treqs[i])


def test_chunked_moe_without_route_block_raises():
    """The reference's rule: ``chunk_prefill`` on an MoE config needs
    ``moe_route_block`` > 0; both engines raise the same error."""
    jp = JT.init_model(jax.random.key(0), JModelConfig(**GRANITE))
    tp = interop.model_params(jax.tree.map(np.asarray, jp))
    msgs = []
    for make, cfg, p, kw in ((JServeEngine, JModelConfig(**GRANITE), jp, {}),
                             (ServeEngine, ModelConfig(**GRANITE), tp,
                              {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            make(cfg, p, chunk_prefill=4, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "moe_route_block" in msgs[0]
