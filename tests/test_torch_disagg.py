"""The port's prefill/decode disaggregation (``repro_torch/serve/disagg.py``,
``core/channels.py::CacheChannel`` and the cache-payload functions of
``kernels/channel_pack.py``) against the JAX package on the CPU, case for
case with ``tests/test_disagg.py``.

Both fronts serve the same requests from the same weights
(``interop.model_params``), in f32.  Exact: payload buffer order, dtypes
and sizes (and the int32 buffer's bytes), every wire byte count, the
planner's migrate-or-local choice of each request at a given bandwidth,
``prefix_pages_saved``, page counts, engine counts and controller
decisions; greedy tokens of migrated and local requests identical to the
reference's and to the port's own ``oracle_generate``.  Float cache
contents agree within 1e-4 plus 1e-4 of their magnitude, the cache gate of
``tests/test_torch_transformer.py`` (the two packages' f32 prefills do not
round bit for bit).  The three cache families are the reference's: KV
(``attention``), xlstm's recurrent states (``ssm``) and zamba2's Mamba2
states beside the shared attention's KV (``hybrid``).  The reference's
model calls run under ``jax.jit`` (its engines jit their own, and every
engine of one kind reuses the first one's compiled programs,
``tests/_jax_serve_jits.py``; the A3C runner's ``collect`` is jitted
here, as in ``tests/test_torch_fault.py``)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import controller as jctl
from repro.core import cost_model as jcost
from repro.kernels import channel_pack as jpack
from repro.models import transformer as JT
from repro import serve as jserve
from repro.serve import telemetry as jtel
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core import controller as tctl
from repro_torch.core import cost_model as tcost
from repro_torch.core.channels import CacheChannel
from repro_torch.kernels import channel_pack as tpack
from repro_torch.models import transformer as TT
from repro_torch import serve as tserve
from repro_torch.serve import telemetry as ttel

import _jax_serve_jits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 64
CASES = {
    "attention": dict(name="d", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=V),
    "ssm": dict(name="x", d_model=64, num_heads=4, num_kv_heads=4, d_ff=0,
                vocab_size=V, block_pattern=("mlstm",) * 3 + ("slstm",),
                num_super=2),
    "hybrid": dict(name="z", d_model=64, num_heads=4, num_kv_heads=4,
                   d_ff=128, vocab_size=V, ssm_state_dim=16,
                   block_pattern=("mamba2",) * 2 + ("attn_shared",),
                   num_super=2),
}
PKG = {"jax": jserve, "torch": tserve}
_PARAMS = {}


@pytest.fixture(autouse=True, scope="module")
def _shared_reference_jits():
    """Every reference engine of one kind reuses the first one's compiled
    programs (``tests/_jax_serve_jits.py``): the same programs on the same
    inputs, compiled once a module instead of once an engine."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_serve_jits.share(mp)
        yield


def params_of(case):
    if case not in _PARAMS:
        jp = JT.init_model(jax.random.key(3), JModelConfig(**CASES[case]))
        _PARAMS[case] = (jp, interop.model_params(jax.tree.map(np.asarray,
                                                               jp)))
    return _PARAMS[case]


def cfgs(case):
    return JModelConfig(**CASES[case]), ModelConfig(**CASES[case])


def ekw(k):
    return {} if k == "jax" else {"device": "cpu"}


def make_fronts(case="attention", *, decode=2, prefill=1, planner=None,
                max_slots=2, max_seq=40, factories=True):
    """A reference front and the port's, built alike.  ``planner`` is a
    dict of ``MigrationPlanner`` kwargs."""
    out = {}
    for k, mod in PKG.items():
        cfg = cfgs(case)[k == "torch"]
        params = params_of(case)[k == "torch"]

        def efac(i, slots=max_slots, mod=mod, cfg=cfg, params=params, k=k):
            return mod.ServeEngine(cfg, params, max_slots=slots,
                                   max_seq=max_seq, name=f"d{i}", **ekw(k))

        def pfac(i, mod=mod, cfg=cfg, params=params, k=k):
            return mod.PrefillEngine(cfg, params, max_seq=max_seq,
                                     name=f"p{i}", **ekw(k))

        if factories:
            router = mod.RequestRouter(engine_factory=efac,
                                       num_engines=decode)
        else:
            router = mod.RequestRouter([efac(i) for i in range(decode)])
        out[k] = mod.DisaggFront(
            router, [pfac(i) for i in range(prefill)],
            planner=mod.MigrationPlanner(**(planner or {})),
            prefill_factory=pfac if factories else None)
    return out


FORCE = dict(bandwidth=1e15, latency_s=0.0, prefill_tok_s=1e-6)


def reqs_mixed(n=4, seed=11, budgets=(5, 8, 3, 6), **kw):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, int(rng.integers(3, 10))),
             budgets[i % len(budgets)], kw) for i in range(n)]


def requests(pairs):
    return {k: [mod.Request(tokens=t, max_new_tokens=b, **kw)
                for t, b, kw in pairs] for k, mod in PKG.items()}


def tokens_by_index(reqs, done):
    idx = {r.rid: i for i, r in enumerate(reqs)}
    return {idx[c.rid]: (c.tokens, c.status) for c in done}


def load(mod, *, backlog=0, occ=0.5, pf_backlog=0, migrations=0, slots=4):
    return mod.ServingLoad(dt=1.0, tokens=100, requests=5,
                           queue_depth_mean=float(backlog),
                           queue_depth_max=backlog, occupancy_mean=occ,
                           backlog=backlog, p50_s=0.05, p95_s=0.1,
                           slots=slots, prefill_backlog=pf_backlog,
                           migrations=migrations)


def controllers(**kw):
    cfg = kw.pop("cfg", {})
    return {"jax": jctl.OnlineGMIController(
                **kw, cfg=jctl.ControllerConfig(**cfg)),
            "torch": tctl.OnlineGMIController(
                **kw, cfg=tctl.ControllerConfig(**cfg))}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ cache pack --
def test_cache_payload_pack_roundtrip_bit_exact():
    """A mixed-dtype tree: one contiguous 1-D buffer a dtype, in the
    reference's order, with the reference's bytes; the round trip is
    bit-exact and every leaf is a view of its buffer."""
    rng = np.random.default_rng(0)
    tree = {"kv": np.linspace(-3.0, 7.0, 24, dtype=np.float32)
            .reshape(2, 3, 4),
            "pos": np.arange(6, dtype=np.int32).reshape(1, 6),
            "state": rng.normal(size=(4, 5)).astype(np.float32)}
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    jtree["state"] = jtree["state"].astype(jnp.bfloat16)
    ttree = {k: torch.as_tensor(v) for k, v in tree.items()}
    ttree["state"] = ttree["state"].to(torch.bfloat16)
    jbufs, _ = jpack.pack_cache_payload(jtree)
    bufs, meta = tpack.pack_cache_payload(ttree)
    assert len(bufs) == 3 and all(b.ndim == 1 for b in bufs)
    assert [str(b.dtype) for b in jbufs] \
        == [str(b.dtype).replace("torch.", "") for b in bufs]
    for jb, b in zip(jbufs, bufs):
        assert b.shape == jb.shape
        np.testing.assert_array_equal(
            b.view(torch.int16).numpy() if b.dtype == torch.bfloat16
            else b.numpy(),
            np.asarray(jb).view(np.int16) if jb.dtype == jnp.bfloat16
            else np.asarray(jb))
    assert tpack.cache_payload_bytes(bufs) \
        == jpack.cache_payload_bytes(jbufs) > 0
    out = tpack.unpack_cache_payload(bufs, meta)
    assert sorted(out) == sorted(ttree)
    for k, a in ttree.items():
        assert out[k].dtype == a.dtype and out[k].shape == a.shape
        assert torch.equal(out[k], a)
        assert out[k].untyped_storage().data_ptr() in {
            b.untyped_storage().data_ptr() for b in bufs}


@pytest.mark.parametrize("case", ["attention", "ssm"])
def test_prefill_cache_payload_matches_reference(case):
    """A real B=1 prefill cache: the same buffers (dtypes, sizes) as the
    reference's, the int32 buffer (slot positions) bit-equal, the floats
    within 1e-4 plus 1e-4 of their magnitude; page-truncated payloads ship the reference's bytes for
    every prompt length and head skip."""
    jcfg, tcfg = cfgs(case)
    jp, tp = params_of(case)
    jprefill = jax.jit(lambda p, b: JT.prefill(p, jcfg, b, 40))
    for L in (5, 17):
        toks = np.arange(L) % V
        _, jc = jprefill(jp, {"tokens": jnp.asarray(toks[None])})
        _, tc = TT.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[None])},
                           40)
        for head in (0, 1):
            if case == "ssm" and head:
                continue
            jt = jpack.truncate_cache_pages(jc, L, 8, head_skip=head)
            tt = tpack.truncate_cache_pages(tc, L, 8, head_skip=head)
            jbufs, _ = jpack.pack_cache_payload(jt)
            bufs, meta = tpack.pack_cache_payload(tt)
            assert tpack.cache_payload_bytes(bufs) \
                == jpack.cache_payload_bytes(jbufs)
            assert [b.shape[0] for b in bufs] \
                == [b.shape[0] for b in jbufs]
            for jb, b in zip(jbufs, bufs):
                if b.dtype == torch.int32:
                    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
                else:
                    np.testing.assert_allclose(b.numpy(), np.asarray(jb),
                                               rtol=1e-4, atol=1e-4)
            back = tpack.unpack_cache_payload(bufs, meta)
            for a, b in zip(jax.tree.leaves(tt), jax.tree.leaves(back)):
                assert torch.equal(a, b)


# ------------------------------------------------------------ cost model --
def test_migration_cost_terms_and_crossover():
    for mod in (jcost, tcost):
        assert mod.migration_time(1e6, 1e9, latency_s=1e-3) \
            == pytest.approx(2e-3)
        assert mod.local_prefill_time(100, 1e3) == pytest.approx(0.1)
        g = [mod.migration_gain(1e6, t, 1e9, 1e3) for t in (1, 10, 100)]
        assert g[0] < g[1] < g[2]
        assert not mod.migration_beats_local(1e6, 1, 1e9, 1e3)
        assert mod.migration_beats_local(1e6, 100, 1e9, 1e3)
    for nb, t, bw, r, lat in ((1e6, 7, 1e9, 1e3, 0.0),
                              (3.3e7, 896, 2e12, 4e4, 1e-4),
                              (5e5, 64, 1e8, 2e3, 1e-3)):
        assert tcost.migration_gain(nb, t, bw, r, lat) \
            == jcost.migration_gain(nb, t, bw, r, lat)


def test_planner_crossover_short_local_long_migrates():
    for mod in PKG.values():
        pl = mod.MigrationPlanner(bandwidth=1e9, latency_s=0.0,
                                  prefill_tok_s=1e3)
        assert not pl.should_migrate(1e6, 1)
        assert pl.should_migrate(1e6, 100)
        assert pl.migrated == 1 and pl.kept_local == 1
        pl.observe_transfer(1.0, int(2e9))
        assert pl.bandwidth == pytest.approx(2e9)
        pl.observe_prefill(500, 0.25)
        assert pl.prefill_tok_s == pytest.approx(0.7 * 1e3 + 0.3 * 2e3)


# --------------------------------------------------------- token identity --
@pytest.mark.parametrize("case", list(CASES))
def test_migrated_decode_token_identical_to_oracle(case):
    """Prefill on a specialist GMI, cache packed over the channel, spliced
    into a decode GMI mid-batch: the reference's greedy tokens and the
    port's own oracle's, for the KV, the xlstm and the zamba2 (Mamba2
    states beside the shared attention's KV) cache families (a sampled
    request, C6, against the port's oracle only)."""
    fronts = make_fronts(case, planner=FORCE)
    pairs = reqs_mixed(4, seed=11) + [(np.arange(6), 6,
                                       dict(temperature=0.8, seed=42))]
    reqs = requests(pairs)
    t = fronts["torch"]
    oracle = [t.router.engines[0].oracle_generate(r) for r in reqs["torch"]]
    out = {}
    for k, f in fronts.items():
        for r in reqs[k]:
            f.submit(r)
        assert f.router.queue_len == 0
        assert sum(e.load for e in f.prefill_engines) == len(pairs)
        out[k] = tokens_by_index(reqs[k], f.drain())
        assert f.planner.migrated == len(pairs)
    assert all(out["torch"][i] == (oracle[i], "ok") for i in range(5))
    assert {i: v for i, v in out["torch"].items() if i < 4} \
        == {i: v for i, v in out["jax"].items() if i < 4}
    eps = {k: f.take_epoch() for k, f in fronts.items()}
    assert eps["torch"].migrations == eps["jax"].migrations == len(pairs)
    assert eps["torch"].prefill_s > 0.0
    assert t.channel.stats.num_transfers == len(pairs)
    assert t.channel.dropped == 0 and t.channel.in_flight == 0


def test_cost_model_chosen_migration_token_identical():
    """Mixed traffic under a real planner decision priced per page: 3- and
    4-token prompts stay local, 8 and 9 migrate, in both packages, and
    every request's tokens equal the reference's and the oracle's."""
    fronts = make_fronts("attention", decode=2, prefill=1)
    rng = np.random.default_rng(7)
    pairs = [(rng.integers(0, V, n), 4, {}) for n in (3, 4, 8, 9, 3, 9)]
    reqs = requests(pairs)
    routes = {}
    out = {}
    for k, f in fronts.items():
        eng = f.router.engines[0]
        f.planner.static_bandwidth = \
            f.payload_bytes / (eng.pages_per_slot * 4.1e-3)
        f.planner.latency_s = 0.0
        f.planner._prefill_tok_s = 1e3
        routes[k] = []
        for r in reqs[k]:
            before = f.planner.migrated
            f.submit(r)
            routes[k].append(f.planner.migrated > before)
        out[k] = tokens_by_index(reqs[k], f.drain())
    assert routes["torch"] == routes["jax"] \
        == [False, False, True, True, False, True]
    assert fronts["torch"].payload_bytes == fronts["jax"].payload_bytes
    oracle = [fronts["torch"].router.engines[0].oracle_generate(r)
              for r in reqs["torch"]]
    assert out["torch"] == out["jax"]
    assert [out["torch"][i][0] for i in range(6)] == oracle


def test_prefill_death_without_survivors_falls_back_to_local():
    """No factory, no surviving specialist: the dead GMI's requests fall
    back to the decode side's local prefill and complete with the
    reference's tokens."""
    fronts = make_fronts(planner=FORCE, factories=False)
    reqs = requests(reqs_mixed(3, seed=21, budgets=(4, 5, 3)))
    out = {}
    for k, f in fronts.items():
        for r in reqs[k]:
            f.submit(r)
        assert f.fail_prefill_engine(f.prefill_engines[0]) == 3
        assert not f.prefill_engines
        out[k] = tokens_by_index(reqs[k], f.drain())
    assert out["torch"] == out["jax"] and len(out["torch"]) == 3
    oracle = [fronts["torch"].router.engines[0].oracle_generate(r)
              for r in reqs["torch"]]
    assert [out["torch"][i] for i in range(3)] == [(o, "ok") for o in oracle]


def test_prefill_death_mid_migration_reprefills_on_a_survivor():
    """A specialist dies with a payload staged on the channel: the staged
    transfer is evicted and re-prefilled, its queued prompts re-route, and
    every request completes with the reference's tokens."""
    fronts = make_fronts(prefill=2, planner=FORCE)
    reqs = requests(reqs_mixed(6, seed=5, budgets=(5,)))
    out = {}
    for k, f in fronts.items():
        for r in reqs[k]:
            f.submit(r)
        doomed = f.prefill_engines[0]
        payload = doomed.step()
        f.channel.send(payload, payload.cache, source=doomed)
        assert f.channel.in_flight == 1
        assert f.fail_prefill_engine(doomed) == 3
        assert f.channel.in_flight == 0 and f.failed_prefill_engines == 1
        out[k] = tokens_by_index(reqs[k], f.drain())
    assert out["torch"] == out["jax"] and len(out["torch"]) == 6


def test_dropped_transfer_is_retransmitted():
    """The channel's drop seam: a dropped payload stays staged and is
    delivered on the next tick; nothing is lost."""
    fronts = make_fronts(planner=FORCE)
    reqs = requests(reqs_mixed(3, seed=8))
    out = {}
    for k, f in fronts.items():
        drops = [True]

        def hook(source, item, drops=drops):
            return "drop" if drops and drops.pop() else None

        f.channel.fault_hook = hook
        out[k] = tokens_by_index(reqs[k], f.serve(reqs[k]))
        assert f.channel.dropped == 1 and f.channel.in_flight == 0
    assert out["torch"] == out["jax"] and len(out["torch"]) == 3


# ---------------------------------------------------- controller arbitration --
def test_controller_prefill_arbitration_grows_and_shrinks():
    ctls = controllers(num_gpu=6, serving_gpus=4, gmi_per_gpu=1, num_env=8,
                       cfg=dict(epoch_rounds=1))
    for c in ctls.values():
        c.prefill_gpus = 1
    d = {k: c.observe_serving(load(jtel if k == "jax" else ttel,
                                   pf_backlog=3, migrations=2))
         for k, c in ctls.items()}
    assert dataclasses.asdict(d["torch"]) == dataclasses.asdict(d["jax"])
    assert d["torch"].prefill_gpus == 2 and "prefill backlog" in \
        d["torch"].reason
    d = {k: c.observe_serving(load(jtel if k == "jax" else ttel))
         for k, c in ctls.items()}
    assert dataclasses.asdict(d["torch"]) == dataclasses.asdict(d["jax"])
    assert d["torch"].prefill_gpus == 1 and "prefill idle" in \
        d["torch"].reason


def test_aggregated_telemetry_never_triggers_prefill_arbitration():
    c = tctl.OnlineGMIController(num_gpu=6, serving_gpus=4, gmi_per_gpu=1,
                                 num_env=8,
                                 cfg=tctl.ControllerConfig(epoch_rounds=1))
    assert c.observe_serving(load(ttel)) is None and c.prefill_gpus == 0


def test_front_apply_decision_scales_prefill_set():
    fronts = make_fronts(prefill=1)
    for k, f in fronts.items():
        ctl = (jctl if k == "jax" else tctl)
        c = ctl.OnlineGMIController(num_gpu=4, serving_gpus=2,
                                    gmi_per_gpu=1, num_env=8)
        c.prefill_gpus = 2
        d = ctl.Decision(num_env=8, gmi_per_gpu=1, serving_gpus=2,
                         reason="grow prefill", prefill_gpus=2, seq=0)
        assert f.apply_decision(d, controller=c) is True
        assert len(f.prefill_engines) == 2
        d0 = ctl.Decision(num_env=8, gmi_per_gpu=1, serving_gpus=2,
                          reason="shrink prefill", prefill_gpus=0, seq=0)
        f.apply_decision(d0, controller=c)
        assert len(f.prefill_engines) == 1


# --------------------------------------------------- double-replan hazard --
def test_stale_decision_refused_and_split_reconciled():
    ctls = controllers(num_gpu=4, serving_gpus=2, gmi_per_gpu=1, num_env=8,
                       cfg=dict(epoch_rounds=1))
    fronts = make_fronts(decode=2)
    for k, f in fronts.items():
        c = ctls[k]
        d = c.observe_serving(load(jtel if k == "jax" else ttel,
                                   backlog=3, occ=1.0))
        assert d.serving_gpus == 3 and d.seq == 0 and c.serving_gpus == 3
        c.plan_seq += 1
        assert f.apply_decision(d, controller=c) is False
        assert f.router.stale_decisions == 1
        assert f.router.num_engines == 2 and c.serving_gpus == 2


def test_decision_applies_at_most_once_per_epoch():
    ctls = controllers(num_gpu=4, serving_gpus=2, gmi_per_gpu=1, num_env=8,
                       cfg=dict(epoch_rounds=1))
    fronts = make_fronts(decode=2)
    for k, f in fronts.items():
        router, c = f.router, ctls[k]
        d = c.observe_serving(load(jtel if k == "jax" else ttel,
                                   backlog=3, occ=1.0))
        assert router.apply_decision(d, controller=c) is True
        assert router.num_engines == 3
        assert router.apply_decision(d, controller=c) is False
        assert router.num_engines == 3 and router.stale_decisions == 0


# -------------------------------------------------- single-arbiter runner --
def test_one_controller_arbitrates_rollout_and_serving(monkeypatch):
    """ONE controller in the AsyncRunner round loop folds rollout telemetry
    and the disaggregated front's epochs, in both packages: the same
    serving-table keys, the same front outcomes, and ``replan`` bumps the
    staleness fence."""
    from repro.core.placement import plan_async as jplan
    from repro.envs import make_env as jmake_env
    from repro.launch.steps import make_async_runner as jmake_runner
    from repro.rl import a3c as ja3c
    from repro.rl.rollout import collect as jcollect
    from repro_torch.core.placement import plan_async as tplan
    from repro_torch.launch.steps import make_async_runner as tmake_runner
    monkeypatch.setattr(ja3c, "collect",
                        jax.jit(jcollect, static_argnums=(1, 5)))
    fronts = make_fronts(decode=2, prefill=1, planner=FORCE)
    jenv = jmake_env("Ant")
    envs = {"jax": jenv, "torch": interop.env_like("Ant", jenv.mega)}
    ctl_cfg = {"jax": jctl.ControllerConfig(epoch_rounds=2, probe=False),
               "torch": tctl.ControllerConfig(epoch_rounds=2, probe=False)}
    runners = {
        "jax": jmake_runner(envs["jax"], jplan(3, 2, 2,
                                               devices=list(range(6)),
                                               devices_per_gpu=2),
                            online_controller=True, router=fronts["jax"],
                            num_envs=4, num_steps=2,
                            controller_cfg=ctl_cfg["jax"]),
        "torch": tmake_runner(envs["torch"], tplan(3, 2, 2,
                                                   devices=list(range(6)),
                                                   devices_per_gpu=2,
                                                   device="cpu"),
                              online_controller=True, router=fronts["torch"],
                              num_envs=4, num_steps=2, device="cpu",
                              controller_cfg=ctl_cfg["torch"]),
    }
    done = {}
    for k, runner in runners.items():
        f = fronts[k]
        assert runner.router is f and runner.controller is not None
        done[k] = []
        for i in range(2):
            reqs = requests(reqs_mixed(2, seed=30 + i, budgets=(3, 4)))[k]
            for r in reqs:
                f.submit(r)
            done[k].append(tokens_by_index(reqs, f.drain()))
            runner.round()
        runner.finish()
    assert done["torch"] == done["jax"]
    tc, jc = runners["torch"].controller, runners["jax"].controller
    assert tc._table and tc._serving_table
    assert sorted(tc._serving_table) == sorted(jc._serving_table)
    assert next(iter(tc._serving_table))[0] == tc.gmi_per_gpu
    assert fronts["torch"].num_engines == fronts["jax"].router.num_engines
    seq0 = tc.plan_seq
    runners["torch"].replan(tctl.Decision(num_env=4, gmi_per_gpu=2,
                                          serving_gpus=2,
                                          reason="fence test"))
    assert tc.plan_seq == seq0 + 1


# ------------------------------------------------------------- paged wires --
def test_paged_migration_ships_partial_payload():
    """Whole pages of the prompt, not the per-slot cache: the wire bytes of
    a 1-page and a 4-page prompt, the measured per-page rate and the
    estimate it feeds equal the reference's."""
    fronts = make_fronts(decode=1, prefill=1, planner=FORCE)
    rng = np.random.default_rng(3)
    pairs = [(rng.integers(0, V, 4), 3, {}), (rng.integers(0, V, 28), 3, {})]
    reqs = requests(pairs)
    got = {}
    for k, f in fronts.items():
        b = []
        out = {}
        for r in reqs[k]:
            out.update(tokens_by_index(reqs[k], f.serve([r])))
            b.append(f._payload_bytes)
        got[k] = (b, f._page_bytes, f.request_bytes(28), f.request_bytes(4),
                  out)
    assert got["torch"] == got["jax"]
    b, page, r28, r4, _ = got["torch"]
    assert b[1] > b[0] > 0 and page > 0 and r28 > r4


def test_shared_prefix_skips_pages_across_migration():
    """A second migrated request sharing a 2-page head: the front strips
    the head pages the decode engine's prefix index holds, in both
    packages, and the spliced decode equals the reference's and the
    oracle's tokens."""
    fronts = make_fronts(decode=1, prefill=1, planner=FORCE, max_seq=48)
    rng = np.random.default_rng(13)
    head = rng.integers(0, V, 16)
    pairs = [(np.concatenate([head, rng.integers(0, V, 3)]), 4, {}),
             (np.concatenate([head, rng.integers(0, V, 6)]), 5, {})]
    reqs = requests(pairs)
    got = {}
    for k, f in fronts.items():
        eng = f.router.engines[0]
        out = tokens_by_index(reqs[k], f.serve(reqs[k][:1]))
        saved0, b0 = f.prefix_pages_saved, f._payload_bytes
        assert eng.shared_head_pages(reqs[k][1].tokens) == 2
        out.update(tokens_by_index(reqs[k], f.serve(reqs[k][1:])))
        got[k] = (saved0, f.prefix_pages_saved, b0, f._payload_bytes,
                  f.planner.migrated, out)
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == (0, 2)
    oracle = [fronts["torch"].router.engines[0].oracle_generate(r)
              for r in reqs["torch"]]
    assert [got["torch"][-1][i][0] for i in range(2)] == oracle


def test_stale_prefix_promise_falls_back_to_local_prefill():
    """A head-stripped payload on an engine that does not hold the
    promised prefix re-queues for a full local prefill, in both packages,
    with the reference's tokens."""
    out = {}
    for k, mod in PKG.items():
        cfg = cfgs("attention")[k == "torch"]
        params = params_of("attention")[k == "torch"]
        pack = jpack if k == "jax" else tpack
        eng = mod.ServeEngine(cfg, params, max_slots=2, max_seq=40,
                              name="d0", **ekw(k))
        pf = mod.PrefillEngine(cfg, params, max_seq=40, name="p0", **ekw(k))
        req = mod.Request(tokens=np.arange(12) % V, max_new_tokens=5)
        pf.submit(req)
        payload = pf.step()
        payload.cache = pack.truncate_cache_pages(
            payload.cache, payload.prompt_tokens, eng.page_size, head_skip=1)
        payload.head_pages = 1
        assert eng.shared_head_pages(req.tokens) == 0
        eng.submit_prefilled(payload)
        done = eng.run_until_idle()
        assert eng.prefix_fallbacks == 1 and len(done) == 1
        out[k] = done[0].tokens
        if k == "torch":
            assert out[k] == eng.oracle_generate(req)
    assert out["torch"] == out["jax"]


def test_cache_channel_streams_are_skipped_on_the_cpu():
    """On the CPU a send records no event and a delivery needs no stream;
    the consumer callable still sees every delivered item in order."""
    ch = CacheChannel()
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.arange(4, dtype=torch.int32)}
    assert ch.send("x", tree, source="p") == 6 * 4 + 4 * 4
    assert ch.send("y", tree, source="q") == 40
    seen = []
    out = ch.deliver(stream=lambda item: seen.append(item))
    assert seen == ["x", "y"] and [i for i, _ in out] == ["x", "y"]
    assert all(torch.equal(t["a"], tree["a"]) for _, t in out)
    assert ch.stats.num_transfers == 2 and ch.stats.ops == 4
    [(sec, nb)] = ch.take_transfer_samples()
    assert nb == 80 and sec >= 0.0
    ch.send("z", tree, source="p")
    assert ch.fail_source("p") == ["z"] and ch.in_flight == 0


def test_serving_launchers_run_without_jax():
    """``launch/serve.py --disagg`` and the two serving counterparts on the
    CPU in a process where importing JAX fails (``llm_policy_serving``
    over the dense, MoE and zamba2 families, and pixtral-12b text only, as
    the reference's example serves it); all default to the card and
    refuse to run without one, and hubert-xlarge, encoder-only, exits
    with ``shape_skips``' reason."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from repro_torch.launch import serve, submesh_serving, "
        "llm_policy_serving\n"
        "for m in (serve, submesh_serving, llm_policy_serving):\n"
        "    try:\n"
        "        m.main(['--disagg'] if m is serve else [])\n"
        "        raise SystemExit(f'{m.__name__} ran on the CPU by default')\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "done = serve.main(['--device', 'cpu', '--disagg', '--batch', '4', "
        "'--prompt-len', '16', '--gen', '6', '--decode-engines', '2', "
        "'--prefill-gmis', '1'])\n"
        "assert len(done) == 4 and all(len(c.tokens) == 6 for c in done)\n"
        "router = submesh_serving.main(['--device', 'cpu'])\n"
        "assert sum(s.requests for s in router.per_gmi_stats()) == 20\n"
        "for arch in ('internlm2-1.8b', 'granite-moe-1b-a400m', "
        "'zamba2-7b', 'pixtral-12b'):\n"
        "    done = llm_policy_serving.main(['--device', 'cpu', '--arch', "
        "arch, '--batch', '2', '--gen', '4'])\n"
        "    assert len(done) == 2 and all(len(c.tokens) == 4 "
        "for c in done)\n"
        "try:\n"
        "    llm_policy_serving.main(['--device', 'cpu', '--arch', "
        "'hubert-xlarge'])\n"
        "    raise AssertionError('an encoder-only arch served')\n"
        "except SystemExit as e:\n"
        "    assert 'encoder-only' in str(e), e\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print('NO_JAX_OK')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    assert "NO_JAX_OK" in out.stdout
    assert "migrated=" in out.stdout and "role=prefill" in out.stdout
