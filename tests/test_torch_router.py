"""The port's multi-GMI serving front (``repro_torch/serve/router.py``)
against the JAX package's ``RequestRouter`` on the CPU, case for case with
``tests/test_serve_router.py``: queue-depth routing, lossless scale-down
and slot resizing, retired workers' telemetry, per-GMI stats,
``ServingRole`` on the MIG-like backend, engine failover, and the online
controller scaling serving GMIs under a load ramp.

Both routers serve the same request sequence from the same weights
(``interop.model_params``).  Integers must be equal: each engine's load
after each submit, completion tokens (f32, greedy), engine counts, and the
count fields of every ``take_epoch`` load.  The timed fields of a load
(``dt``, latencies, prefill and decode seconds) follow each host's clock,
so where a controller decides, both controllers are fed the same load: the
port's, with its count fields asserted equal to the reference's and its
timed fields pinned (``_pinned``), and their decisions must be equal."""
import dataclasses
import warnings

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import controller as jctl
from repro.core.gmi import GMIManager as JGMIManager
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import RequestRouter as JRouter
from repro.serve import ServeEngine as JEngine
from repro.serve import ServingRole as JRole
from repro.serve import telemetry as jtel
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core import controller as tctl
from repro_torch.core.gmi import GMIManager
from repro_torch.serve import (Request, RequestRouter, ServeEngine,
                               ServingRole, merge_loads)
from repro_torch.serve import telemetry as ttel

import _jax_serve_jits

V = 64
KW = dict(name="d", num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
          d_ff=64, vocab_size=V)
JCFG, CFG = JModelConfig(**KW), ModelConfig(**KW)
JPARAMS = JT.init_model(jax.random.key(0), JCFG)
PARAMS = interop.model_params(jax.tree.map(np.asarray, JPARAMS))

# count fields of a ServingLoad: equal across packages for one sequence
COUNTS = ("tokens", "requests", "queue_depth_mean", "queue_depth_max",
          "occupancy_mean", "backlog", "slots", "mem_bytes",
          "prefill_backlog", "migrations", "free_pages", "total_pages")


@pytest.fixture(autouse=True, scope="module")
def _shared_reference_jits():
    """Every reference engine of one kind reuses the first one's compiled
    programs (``tests/_jax_serve_jits.py``): the same programs on the same
    inputs, compiled once a module instead of once an engine."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_serve_jits.share(mp)
        yield


def jeng(i, slots=2):
    return JEngine(JCFG, JPARAMS, max_slots=slots, max_seq=32, name=f"e{i}")


def teng(i, slots=2):
    return ServeEngine(CFG, PARAMS, max_slots=slots, max_seq=32,
                       device="cpu", name=f"e{i}")


FACT = {"jax": jeng, "torch": teng}
REQ = {"jax": JRequest, "torch": Request}


def routers(n=2, *, factory=False, fixed=True, num_engines=None):
    """A reference router and the port's, built alike."""
    out = {}
    for k, make in FACT.items():
        kw = {}
        if factory:
            kw["engine_factory"] = make
        if num_engines is not None:
            kw["num_engines"] = num_engines
        engines = [make(i) for i in range(n)] if fixed else None
        out[k] = (JRouter if k == "jax" else RequestRouter)(engines, **kw)
    return out


def stream(seed, n, gen=4, plen=6):
    """``n`` (prompt, budget) pairs; ``gen`` an int or a function of i."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, plen), gen(i) if callable(gen) else gen)
            for i in range(n)]


def submit(rs, pairs):
    """Submit the same requests to every router; each router's engine
    loads after each submit must be equal.  Returns the requests."""
    reqs = {k: [REQ[k](tokens=t, max_new_tokens=b) for t, b in pairs]
            for k in rs}
    for i in range(len(pairs)):
        loads = {}
        for k, r in rs.items():
            r.submit(reqs[k][i])
            loads[k] = [e.load for e in r.engines]
        assert loads["torch"] == loads["jax"]
    return reqs


def by_index(reqs, done):
    idx = {r.rid: i for i, r in enumerate(reqs)}
    return {idx[c.rid]: (c.tokens, c.status) for c in done}


def counts(load):
    return {k: getattr(load, k) for k in COUNTS}


def _pinned(load, mod):
    """``load``'s count fields with its timed fields pinned."""
    return mod.ServingLoad(**counts(load), dt=1.0, p50_s=0.05, p95_s=0.1,
                           prefill_s=0.0, decode_s=0.0)


def epochs(rs):
    """Both routers' take_epoch, count fields equal; the port's load."""
    loads = {k: r.take_epoch() for k, r in rs.items()}
    assert counts(loads["torch"]) == counts(loads["jax"])
    return loads["torch"]


def controllers(**kw):
    cfg = kw.pop("cfg", {})
    return {"jax": jctl.OnlineGMIController(
                **kw, cfg=jctl.ControllerConfig(**cfg)),
            "torch": tctl.OnlineGMIController(
                **kw, cfg=tctl.ControllerConfig(**cfg))}


def decide(ctls, load):
    """Both controllers observe the same (pinned) load; equal decisions."""
    d = {"jax": ctls["jax"].observe_serving(_pinned(load, jtel)),
         "torch": ctls["torch"].observe_serving(_pinned(load, ttel))}
    if d["jax"] is None:
        assert d["torch"] is None
    else:
        assert dataclasses.asdict(d["torch"]) == dataclasses.asdict(d["jax"])
    return d


# ----------------------------------------------------------------- routing --
def test_routes_by_queue_depth():
    rs = routers()
    submit(rs, stream(0, 6))
    assert [e.load for e in rs["torch"].engines] == [3, 3]


def test_router_drain_completes_everything():
    rs = routers()
    reqs = submit(rs, stream(1, 7, gen=lambda i: 3 + i % 3))
    out = {k: by_index(reqs[k], r.drain()) for k, r in rs.items()}
    assert out["torch"] == out["jax"] and len(out["torch"]) == 7
    assert not rs["torch"].busy
    # a rid the router has already accepted is refused
    with pytest.raises(ValueError, match="duplicate rid"):
        rs["torch"].submit(reqs["torch"][0])


def test_scale_down_loses_no_request():
    rs = routers(factory=True)
    reqs = submit(rs, stream(2, 8))
    for r in rs.values():
        r.scale_to(1)
        assert r.num_engines == 1
    out = {k: by_index(reqs[k], list(r.completions) + r.drain())
           for k, r in rs.items()}
    assert out["torch"] == out["jax"] and len(out["torch"]) == 8
    assert all(len(t) == 4 for t, _ in out["torch"].values())


def test_scale_up_via_factory():
    for cls, make in ((JRouter, jeng), (RequestRouter, teng)):
        router = cls(engine_factory=make, num_engines=1)
        assert router.num_engines == 1
        router.scale_to(3)
        assert router.num_engines == 3
        fixed = cls([make(0)])
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            fixed.scale_to(4)
        assert fixed.num_engines == 1
        assert any("no engine_factory" in str(x.message) for x in w)


def test_resize_slots_is_lossless():
    rs = routers(n=0, factory=True, fixed=False, num_engines=2)
    reqs = submit(rs, stream(7, 6))
    for r in rs.values():
        r.step()
        assert r.resize_slots(4)
        assert all(e.max_slots == 4 for e in r.engines)
        assert r.num_engines == 2
    out = {k: by_index(reqs[k], list(r.completions) + r.drain())
           for k, r in rs.items()}
    assert out["torch"] == out["jax"] and len(out["torch"]) == 6
    assert all(len(t) == 4 for t, _ in out["torch"].values())
    assert not rs["torch"].resize_slots(4)
    assert not RequestRouter([teng(0)]).resize_slots(8)


def test_retired_worker_telemetry_reaches_next_epoch():
    """Scale-down must not hide the retiring worker's drained tokens and
    latencies from the controller."""
    rs = routers(factory=True)
    submit(rs, stream(8, 4, gen=3))
    for r in rs.values():
        r.step()
        r.scale_to(1)
        r.drain()
    load = epochs(rs)
    assert load.tokens == 12 and load.requests == 4 and load.slots == 2


def test_per_gmi_stats_and_epoch_merge():
    rs = routers()
    submit(rs, stream(3, 4, gen=3))
    for r in rs.values():
        r.drain()
    per = {k: [counts(s) for s in r.per_gmi_stats()] for k, r in rs.items()}
    assert per["torch"] == per["jax"]
    assert [s["tokens"] for s in per["torch"]] == [6, 6]
    total = epochs(rs)
    assert total.tokens == 12 and total.requests == 4 and total.slots == 4
    assert epochs(rs).tokens == 0


def test_merge_loads_empty():
    z, jz = merge_loads([]), jtel.merge_loads([])
    assert counts(z) == counts(jz)
    assert z.tokens == 0 and z.tok_s == 0.0


def test_backdated_submit_does_not_rewind_epoch_span():
    """A re-routed request keeps its latency clock; the epoch span follows
    the wall clock (both packages, on a fake clock)."""
    for mod in (jtel, ttel):
        now = [1000.0]
        tel = mod.ServingTelemetry(slots=2, clock=lambda: now[0])
        tel.take_epoch()
        tel.on_submit(1, t=now[0] - 100.0)
        now[0] += 0.5
        tel.on_step(0.01, active=1, queued=0, tokens_out=1)
        assert tel.snapshot().dt == 0.5
        tel.on_finish(1)
        assert tel.percentiles()[0] == 100.5


def test_fail_engine_reroutes_and_restarts():
    """A dead engine's queued requests re-route, its in-flight ones restart
    on a survivor under the retry cap; tokens equal the reference's and
    every request completes ok."""
    rs = routers(n=3)
    reqs = submit(rs, stream(0, 9, gen=5))
    for r in rs.values():
        r.step()
        assert r.fail_engine(r.engines[1]) == []
        assert r.num_engines == 2 and r.failed_engines == 1
    out = {k: by_index(reqs[k], r.drain()) for k, r in rs.items()}
    assert out["torch"] == out["jax"] and len(out["torch"]) == 9
    assert all(s == "ok" for _, s in out["torch"].values())
    # the retry cap: a request whose engine dies twice with max_retries=1
    for k, r in routers(n=3).items():
        req = REQ[k](tokens=np.arange(6) % V, max_new_tokens=8)
        r.submit(req)
        r.step()
        r.fail_engine(next(e for e in r.engines if e.active_count), 1)
        r.step()
        done = r.fail_engine(next(e for e in r.engines if e.active_count), 1)
        assert [c.status for c in done] == ["failed"] and not r.busy


def test_maybe_replan_reconciles_when_fleet_cannot_follow():
    """A fixed engine list cannot scale; the controller's committed split
    snaps back to the real fleet every epoch, in both packages."""
    for cls, make, mod, ctl in ((JRouter, jeng, jctl, jctl),
                                (RequestRouter, teng, tctl, tctl)):
        router = cls([make(0)])
        c = ctl.OnlineGMIController(
            num_gpu=4, serving_gpus=1, gmi_per_gpu=1, num_env=64,
            cfg=ctl.ControllerConfig(epoch_rounds=1))
        rng = np.random.default_rng(11)
        req = REQ["jax" if cls is JRouter else "torch"]
        for _ in range(3):
            for _ in range(4):
                for _ in range(4):
                    router.submit(req(tokens=rng.integers(0, V, 6),
                                      max_new_tokens=6))
                router.step()
            router.maybe_replan(c)
            assert c.serving_gpus == 1
        assert router.num_engines == 1
        router.drain()


# ------------------------------------------------------------- ServingRole --
def test_serving_role_gmi_run_on_submesh():
    """Listing 1's serving instance on the MIG-like backend: the engine is
    built on the GMI's own context and serves the reference's tokens."""
    mgr = GMIManager(devices=[0], devices_per_gpu=1, backend="submesh",
                     device="cpu")
    role = ServingRole(mgr, 0, 0, CFG, PARAMS, max_slots=2, max_seq=32)
    jmgr = JGMIManager(devices=jax.devices(), devices_per_gpu=1,
                       backend="submesh")
    jrole = JRole(jmgr, 0, 0, JCFG, JPARAMS, max_slots=2, max_seq=32)
    assert mgr.gmis[0].role == jmgr.gmis[0].role == "serving"
    assert role.engine.gmi is not None and role.engine.stream is None
    pairs = stream(4, 3)
    jreqs = [JRequest(tokens=t, max_new_tokens=b) for t, b in pairs]
    treqs = [Request(tokens=t, max_new_tokens=b) for t, b in pairs]
    assert by_index(treqs, role.gmi_run(treqs)) \
        == by_index(jreqs, jrole.gmi_run(jreqs))
    probe = Request(tokens=np.arange(5), max_new_tokens=5)
    assert role.gmi_run([probe])[0].tokens \
        == role.engine.oracle_generate(probe) \
        == jrole.engine.oracle_generate(JRequest(tokens=np.arange(5),
                                                 max_new_tokens=5))
    # the axis backend builds the engine on the current stream
    amgr = GMIManager(devices=[0], devices_per_gpu=1, device="cpu")
    assert ServingRole(amgr, 0, 0, CFG, PARAMS).engine.gmi is None


# -------------------------------------------- controller under a load ramp --
def test_controller_scales_serving_gmis_under_load_ramp():
    """Open-loop traffic outruns one engine; both controllers, fed the
    same epochs, move GPUs to serving 1 -> 2 -> 3 with equal decisions,
    and the idle epochs after the traffic stops give one back."""
    rs = routers(n=0, factory=True, fixed=False, num_engines=1)
    ctls = controllers(num_gpu=4, serving_gpus=1, gmi_per_gpu=1, num_env=64,
                       cfg=dict(epoch_rounds=2))
    rng = np.random.default_rng(5)
    sizes = [1]
    recorded = []
    for _ in range(8):
        for _ in range(4):
            submit(rs, [(rng.integers(0, V, 6), 6) for _ in range(3)])
            for r in rs.values():
                r.step()
        load = epochs(rs)
        recorded.append(load)
        d = decide(ctls, load)
        for k, r in rs.items():
            if d[k] is not None and d[k].layout_changed:
                r.scale_to(d[k].serving_gpus)
        assert rs["torch"].num_engines == rs["jax"].num_engines
        sizes.append(rs["torch"].num_engines)
        if sizes[-1] == 3:
            break
    assert sizes[-1] == 3 and sizes == sorted(sizes)
    ups = [d for d in ctls["torch"].decisions if "+1 serving GPU" in d.reason]
    assert len(ups) == 2 and all("serving backlog" in d.reason for d in ups)
    assert any(l.backlog > 0 and l.occupancy_mean > 0.9 for l in recorded)
    for r in rs.values():
        r.drain()
    epochs(rs)
    for _ in range(2):
        d = decide(ctls, epochs(rs))
    assert d["torch"] is not None and d["torch"].serving_gpus == 2
    assert "serving idle" in d["torch"].reason
    for k, r in rs.items():
        r.scale_to(d[k].serving_gpus)
    assert rs["torch"].num_engines == rs["jax"].num_engines == 2


@pytest.mark.parametrize("case", ["split", "slot_probe", "per_gpu"])
def test_apply_decision_follows_controller(case):
    """The runner-style loop (take_epoch, observe_serving,
    apply_decision) in both packages on the same epochs: equal decisions
    and equal engine sets.  ``split`` moves a GPU to serving, ``slot_probe``
    (at the largest split) rebuilds the engines wider, ``per_gpu`` scales
    to serving_gpus x gmi_per_gpu engines."""
    ctl_kw, n, arrivals = {
        "split": (dict(num_gpu=3, serving_gpus=1, gmi_per_gpu=1), 1, 4),
        "slot_probe": (dict(num_gpu=2, serving_gpus=1, gmi_per_gpu=1), 1, 4),
        "per_gpu": (dict(num_gpu=4, serving_gpus=1, gmi_per_gpu=2), 2, 6),
    }[case]
    rs = routers(n=0, factory=True, fixed=False, num_engines=n)
    ctls = controllers(**ctl_kw, num_env=64, cfg=dict(epoch_rounds=1))
    rng = np.random.default_rng({"split": 6, "slot_probe": 9,
                                 "per_gpu": 10}[case])
    changed = {}
    for _ in range(4):
        for _ in range(4):
            submit(rs, [(rng.integers(0, V, 6), 6)
                        for _ in range(arrivals)])
            for r in rs.values():
                r.step()
        d = decide(ctls, epochs(rs))
        changed = {k: r.apply_decision(d[k], controller=ctls[k])
                   for k, r in rs.items()}
        assert changed["torch"] == changed["jax"]
        assert [e.max_slots for e in rs["torch"].engines] \
            == [e.max_slots for e in rs["jax"].engines]
        if changed["torch"]:
            break
    assert changed["torch"]
    t = rs["torch"]
    if case == "split":
        assert t.num_engines == ctls["torch"].serving_gpus == 2
    elif case == "slot_probe":
        assert all(e.max_slots == 4 for e in t.engines)
        assert "probe slots=4" in ctls["torch"].decisions[-1].reason
    else:
        assert ctls["torch"].serving_gpus == 2 and t.num_engines == 4
    # a decision applies at most once
    assert not t.apply_decision(ctls["torch"].decisions[-1],
                                controller=ctls["torch"])
    out = {k: len(r.drain()) for k, r in rs.items()}
    assert out["torch"] == out["jax"]


def test_maybe_replan_applies_decision():
    """``maybe_replan`` itself, per package: under sustained backlog the
    router grows to the controller's split."""
    for cls, make, ctl, req in ((JRouter, jeng, jctl, JRequest),
                                (RequestRouter, teng, tctl, Request)):
        router = cls(engine_factory=make, num_engines=1)
        c = ctl.OnlineGMIController(
            num_gpu=3, serving_gpus=1, gmi_per_gpu=1, num_env=64,
            cfg=ctl.ControllerConfig(epoch_rounds=1))
        rng = np.random.default_rng(6)
        changed = False
        for _ in range(3):
            for _ in range(4):
                for _ in range(4):
                    router.submit(req(tokens=rng.integers(0, V, 6),
                                      max_new_tokens=6))
                router.step()
            changed = router.maybe_replan(c) or changed
            if changed:
                break
        assert changed and router.num_engines == c.serving_gpus == 2
        router.drain()
