"""Parity of the port's fault subsystem with the JAX package on the CPU:
``FaultPlan`` schedules, the pipeline's drop/poison/requeue seams, the
runner's non-finite guard, and the supervised fleet (``FleetSupervisor``
over ``make_fleet_supervisor``) against the reference's, one case per
runner-side fault kind, plus the factories in a process where JAX cannot
be imported.

The fleet cases follow ``tests/test_fault_recovery.py::build`` (Ant, a
3-GPU async layout of 2 GMIs a GPU, 4 envs a GMI, T = 2).  Params, Adam
state and env states are carried from the reference runner after every
rebuild of its actors, and each actor's action noise is replayed from its
JAX key, as in ``tests/test_torch_a3c.py``.  The reference's un-jitted
``collect`` re-traces its scan on every call, so these tests run it under
``jax.jit`` (the same computation, compiled once).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import fault as jfault
from repro.core.placement import plan_async as jplan_async
from repro.envs import make_env as jax_make_env
from repro.launch.steps import make_fleet_supervisor as jmake_fleet
from repro.rl import a3c as ja3c
from repro.rl.rollout import collect as jcollect
from repro_torch import fault as tfault
from repro_torch import interop, utils
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core.channels import MultiChannelPipeline
from repro_torch.core.placement import plan_async as tplan_async
from repro_torch.launch.steps import make_fleet_supervisor as tmake_fleet
from repro_torch.rl import a3c as ta3c

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
T, N = 2, 4


@pytest.fixture(autouse=True)
def _jitted_reference_collect(monkeypatch):
    monkeypatch.setattr(ja3c, "collect",
                        jax.jit(jcollect, static_argnums=(1, 5)))


def _np(x):
    return jax.tree.map(np.array, x)


def _leaves(tree):
    """Leaves as numpy arrays in JAX's flatten order (sorted dict keys),
    for a port tree or a reference one."""
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for _, x in tckpt.keystr_leaves(tree)]


def _replay_noise(key, act):
    draws = []
    for _ in range(T):
        key, akey = jax.random.split(key)
        draws.append(np.array(jax.random.normal(akey, (N, act))))
    return torch.as_tensor(np.stack(draws))


def _events(mod, events):
    return mod.FaultPlan([mod.FaultEvent(**e) for e in events])


# -------------------------------------------------------------- the plan --
@pytest.mark.parametrize("seed", range(20))
def test_fault_plan_random_matches_reference(seed):
    """Same seed, same schedule: the default kinds and a custom mix."""
    for kw in ({}, dict(kinds=("kill_serving", "kill_trainer",
                               "channel_poison", "ckpt_tear"),
                        rate=0.5, targets=(0, 1, 2, 3, 100))):
        a = jfault.FaultPlan.random(seed=seed, rounds=40, **kw)
        b = tfault.FaultPlan.random(seed=seed, rounds=40, **kw)
        assert [tuple(vars(e).values()) for e in a.events] \
            == [tuple(vars(e).values()) for e in b.events]


def test_fault_plan_take_sequence_matches_reference():
    """Fire-once, late-fire and wildcard matching: one sequence of
    advance/take calls answers the same in both packages."""
    ev = [dict(kind="kill_serving", round=2, target=5),
          dict(kind="engine_fail", round=0),
          dict(kind="ckpt_tear", round=1, mode="torn_npz"),
          dict(kind="channel_drop", round=3, target=-1)]
    calls = [(0, "kill_serving", 5), (2, "kill_serving", 4),
             (2, "kill_serving", 5), (2, "kill_serving", 5),
             (0, "engine_fail", 3), (4, "ckpt_tear", None),
             (4, "channel_drop", 0), (4, "channel_drop", None)]
    out = []
    for mod in (jfault, tfault):
        plan, got = _events(mod, ev), []
        for r, kind, target in calls:
            plan.advance(r)
            e = plan.take(kind, target=target)
            got.append(None if e is None else tuple(vars(e).values()))
        got.append(plan.exhausted)
        out.append(got)
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        tfault.FaultEvent("meteor_strike", round=0)
    assert tfault.KINDS == jfault.KINDS
    assert tfault.TEAR_MODES == jfault.TEAR_MODES


def test_tear_and_crash_hook(tmp_path):
    d = str(tmp_path)
    for s in (1, 2):
        tckpt.save(os.path.join(d, f"ckpt_{s}"), {"w": torch.ones(64)},
                   step=s)
    tfault.tear_checkpoint(d, 2, mode="missing_npz")
    assert tckpt.steps(d) == [1]
    npz = tfault.tear_checkpoint(d, 1, mode="torn_npz")
    with pytest.raises(ValueError, match="torn"):
        tckpt.load(npz[:-4], {"w": torch.ones(64)}, device="cpu")
    with pytest.raises(ValueError):
        tfault.tear_checkpoint(d, 1, mode="shredded")
    with pytest.raises(ValueError):
        tfault.make_save_crash_hook("after_everything")
    hook = tfault.make_save_crash_hook("before_manifest")
    hook("before_npz")
    with pytest.raises(tfault.InjectedFault) as e:
        hook("before_manifest")
    assert e.value.event.kind == "ckpt_tear"


# ---------------------------------------------------------- the seams --
def _exp(v, fill=0.0, n=N):
    return ta3c.Experience(
        obs=torch.full((T, n, 3), fill), actions=torch.full((T, n, 2), fill),
        rewards=torch.full((T, n), fill), dones=torch.zeros((T, n)),
        bootstrap=torch.full((n,), fill),
        actor_version=torch.tensor(v, dtype=torch.int32))


def _producer(fill):
    def producer(bufs, slot):
        for c in ("obs", "actions", "rewards"):
            bufs[c][:, slot * N:(slot + 1) * N] = fill
        return bufs, torch.full((N,), fill), 0
    return producer


def test_dropped_payload_keeps_its_storage_across_later_produces():
    """A dropped flush re-enters ``_pending`` holding the storage its
    snapshot handed over; the next produce into the same ring allocates
    afresh, so the retransmitted payload is the one that was dropped."""
    pipe = MultiChannelPipeline([0, 1], [9])
    actions = iter(["drop", None, None])
    pipe.fault_hook = lambda g, ch: next(actions)
    for a, fill in ((0, 1.0), (1, 2.0)):
        pipe.produce(a, T, N, 3, 2, _producer(fill), device="cpu")
    assert pipe.flush() == {} and pipe.dropped_flushes == 1
    held = pipe._pending[-1][0]
    ptr = held["rewards"].data_ptr()
    for a, fill in ((0, 7.0), (1, 8.0)):
        pipe.produce(a, T, N, 3, 2, _producer(fill), device="cpu")
    out = pipe.flush()[9]
    assert [float(e.rewards[0, 0]) for e in out] == [1.0, 7.0]
    assert out[0].rewards.data_ptr() == ptr
    assert out[0].rewards[:, N:].eq(2.0).all()
    assert out[1].rewards.data_ptr() != ptr
    assert pipe.delivered_samples == 2 * 2 * T * N


def test_poison_requeue_and_bounded_drain():
    pipe = MultiChannelPipeline([0], [9], overlap=True)
    pipe.fault_hook = lambda g, ch: "poison"
    pipe.push(0, _exp(0, 1.0))
    assert pipe.flush() == {}                  # overlap: one round behind
    out = pipe.drain()[9]
    assert len(out) == 1 and out[0].rewards.isnan().all()
    assert bool(out[0].obs.eq(1.0).all()) and pipe.poisoned_flushes == 1
    # requeue: consumed-but-untrained batches re-deliver in order
    pipe = MultiChannelPipeline([0], [9])
    pipe.requeue([_exp(3, 5.0), _exp(4, 6.0)])
    out = pipe.flush()[9]
    assert [float(e.rewards[0, 0]) for e in out] == [5.0, 6.0]
    assert [int(e.actor_version) for e in out] == [3, 4]
    # a hook that drops everything forever: the drain gives up after 8
    # retransmission rounds and the payload stays pending
    pipe.fault_hook = lambda g, ch: "drop"
    pipe.push(0, _exp(0, 1.0))
    assert pipe.drain() == {}
    assert pipe.dropped_flushes == 9 and len(pipe._pending[-1]) == 1


def test_trainer_update_and_adam_leave_inputs_unmodified():
    """The guard's rollback is free only because neither update writes in
    place: every input leaf keeps its values and version counter."""
    from repro_torch.models.policy import init_policy
    from repro_torch.optim import adam_init, adam_update
    params = init_policy(torch.Generator().manual_seed(0), (3, 8, 2))
    opt = adam_init(params)
    exp = _exp(0, 0.5)
    leaves = utils.tree_leaves((params, opt))
    before = [(x.clone(), x._version) for x in leaves]
    p2, o2, loss = ta3c.trainer_update(params, opt, exp)
    grads = utils.tree_map(torch.ones_like, params)
    p3, o3 = adam_update(grads, o2, p2, lr=1e-3, grad_clip=1.0)
    for x, (v, ver) in zip(leaves, before):
        assert torch.equal(x, v) and x._version == ver
    assert all(not torch.equal(a, b) for a, b in zip(
        utils.tree_leaves(p2["trunk"]), utils.tree_leaves(params["trunk"]))
        if a.dim() == 2)


def test_nonfinite_guard_rolls_back_to_the_same_objects():
    env = interop.env_like("Ant", jax_make_env("Ant").mega)
    r = ta3c.AsyncRunner(env, [0], [1], num_envs=N, num_steps=T,
                         device="cpu")
    r.nonfinite_guard = True
    r.pipe.fault_hook = lambda g, ch: "poison"
    params, opt = r.params, r.opt_state
    losses, stale = r.round()
    assert losses == [] and stale == [0]
    assert r.params is params and r.opt_state is opt and r.version == 0
    assert (r.poisoned_batches, r.poisoned_samples) == (1, T * N)
    assert r.trained_samples + r.poisoned_samples == r.predictions


def test_runner_refuses_router_and_mesh_communicator():
    """A ``router=`` that is not a serving front (no ``take_epoch`` /
    ``apply_decision``) and a mesh-attached Communicator are refused; a
    serving front is accepted, by the runner and the fleet factory."""
    env = interop.env_like("Ant", jax_make_env("Ant").mega)
    with pytest.raises(TypeError, match="serving front"):
        ta3c.AsyncRunner(env, [0], [1], num_envs=N, num_steps=T,
                         router=object(), device="cpu")
    layout = tplan_async(3, 2, 2, devices=list(range(6)),
                         devices_per_gpu=2, device="cpu")
    with pytest.raises(TypeError, match="serving front"):
        tmake_fleet(env, layout, router=object(), num_envs=N, num_steps=T,
                    device="cpu")
    router = _routers(fronts=False)["torch"]
    sup = tmake_fleet(env, layout, router=router, num_envs=N, num_steps=T,
                      device="cpu")
    assert sup.router is router and sup.runner.router is router
    from repro_torch.comm import Communicator
    meshy = Communicator("mrr", grid=(2, 2))
    meshy.mesh = object()
    with pytest.raises(TypeError, match="SPMD-only"):
        ta3c.AsyncRunner(env, [0], [1], num_envs=N, num_steps=T,
                         communicator=meshy, device="cpu")


# --------------------------------------------------- the supervised fleet --
def _fleet_pair(events, tmp_path=None, **kw):
    jenv = jax_make_env("Ant", megakernel=kw.get("megakernel", False))
    tenv = interop.env_like("Ant", jenv.mega,
                            megakernel=kw.pop("megakernel", False))
    sups = []
    for mod, env, make, plan_async, extra in (
            (jfault, jenv, jmake_fleet, jplan_async, {}),
            (tfault, tenv, tmake_fleet, tplan_async, {"device": "cpu"})):
        layout = plan_async(3, kw.get("serving_gpus", 2), 2,
                            devices=list(range(6)), devices_per_gpu=2,
                            **extra)
        ckpt = {} if tmp_path is None else dict(
            ckpt_dir=str(tmp_path / mod.__name__), ckpt_every=2)
        sups.append(make(env, layout, plan=_events(mod, events),
                         num_envs=N, num_steps=T,
                         probation=kw.get("probation", 2), **ckpt, **extra))
    js, ts = sups
    ts.runner.params = interop.policy_params(_np(js.runner.params))
    ts.runner.opt_state = interop.adam_state(_np(js.runner.opt_state))
    ts.runner.actor_params = ts.runner.params
    _carry_actors(js.runner, ts.runner)
    return js, ts


def _carry_actors(jr, tr):
    assert sorted(tr.actors) == sorted(jr.actors)
    for a, (es, obs, _) in jr.actors.items():
        tr.actors[a] = [interop.env_state(_np(es)),
                        torch.as_tensor(np.array(obs)), tr.actors[a][2]]


def _run_pair(js, ts, rounds):
    jr, tr = js.runner, ts.runner
    act = jr.env.spec.act_dim
    for _ in range(rounds):
        assert (tr.num_envs, tr.serving_gmis) == (jr.num_envs,
                                                  jr.serving_gmis)
        noise = {a: _replay_noise(jr.actors[a][2], act)
                 for a in jr.serving_gmis}
        replans = jr.replans
        jl, jst = js.round()
        tl, tst = ts.round(noise)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        assert tst == jst
        assert tr.replans == jr.replans
        if jr.replans != replans:       # actors rebuilt on both sides
            _carry_actors(jr, tr)
    jl, jst = jr.finish()
    tl, tst = tr.finish()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert tst == jst


def _assert_same_fleet(js, ts):
    jr, tr = js.runner, ts.runner
    for k in ("failures", "recoveries", "quarantined", "ckpt_steps",
              "num_gpu", "serving_gpus", "rounds_total", "healthy_streak"):
        assert getattr(ts, k) == getattr(js, k), k
    for k in ("predictions", "trained_samples", "poisoned_batches",
              "poisoned_samples", "replans", "rounds", "num_envs"):
        assert getattr(tr, k) == getattr(jr, k), k
    assert tr.version == int(jr.version)
    for k in ("dropped_flushes", "poisoned_flushes", "spill_count",
              "delivered_samples"):
        assert getattr(tr.pipe, k) == getattr(jr.pipe, k), k
    assert tr.trained_samples + tr.poisoned_samples == tr.predictions
    for g, w in zip(_leaves(tr.params), _leaves(jr.params)):
        np.testing.assert_allclose(g, w, atol=1e-5)
        assert np.isfinite(g).all()


FLEET_CASES = {
    "kill_serving": dict(events=[dict(kind="kill_serving", round=1)],
                         rounds=5),
    "kill_trainer": dict(events=[dict(kind="kill_trainer", round=1)],
                         rounds=4, serving_gpus=1, probation=10),
    "channel_drop": dict(events=[dict(kind="channel_drop", round=1)],
                         rounds=3),
    "channel_poison": dict(events=[dict(kind="channel_poison", round=1)],
                           rounds=3, megakernel=True),
    "ckpt_tear": dict(events=[dict(kind="ckpt_tear", round=4,
                                   mode="before_manifest"),
                              dict(kind="ckpt_tear", round=6,
                                   mode="torn_npz")],
                      rounds=6, ckpt=True),
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_supervised_fleet_matches_reference(case, tmp_path):
    """Each runner-side fault kind under both supervisors: failure,
    recovery, quarantine and checkpoint logs and every integer counter
    equal, losses to 1e-4, params to 1e-5 (the atol of
    ``test_async_runner_rounds_match_reference``); the kill cases recover
    through a reduced-pool re-plan (``kill_serving`` also re-admits after
    probation 2), ``channel_poison`` runs the direct-produce branch."""
    kw = dict(FLEET_CASES[case])
    events, rounds = kw.pop("events"), kw.pop("rounds")
    js, ts = _fleet_pair(events, tmp_path if kw.pop("ckpt", False)
                         else None, **kw)
    _run_pair(js, ts, rounds)
    _assert_same_fleet(js, ts)
    assert [f["kind"] for f in ts.failures] \
        == [e["kind"] for e in events]
    if case == "kill_serving":
        assert [r["kind"] for r in ts.recoveries] == ["kill_serving",
                                                      "readmit"]
    if case == "channel_poison":
        assert ts.runner.poisoned_batches == 1
    if case == "ckpt_tear":
        # step 4 crashed before its manifest, step 6 was torn after it:
        # a fresh runner of either package skips 6 and resumes at 2 from
        # either package's files, and both packages read the reference's
        # step 2 bit for bit
        jd, td = js.ckpt_dir, ts.ckpt_dir
        assert tckpt.steps(td) == tckpt.steps(jd) == [2, 6]
        got = {}
        for name, make, sup, extra in (
                ("jax", jmake_fleet, js, {}),
                ("torch", tmake_fleet, ts, {"device": "cpu"})):
            for d in (jd, td):
                fresh = make(sup.runner.env, sup.layout, num_envs=N,
                             num_steps=T, **extra).runner
                assert fresh.restore(d) == 2
                assert fresh.rounds == 2 and fresh.replans == 0
                got[name, d] = _leaves(fresh.params)
        for a, b, c in zip(got["jax", jd], got["torch", jd],
                           got["torch", td]):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_allclose(c, a, atol=1e-5)


def test_same_plan_twice_same_fleet():
    """A seeded random plan of GMI kills, drops and poisons, run twice in
    each package: the four runs give the same logs and counters."""
    def events():
        plan = jfault.FaultPlan.random(
            seed=3, rounds=5, kinds=("kill_serving", "kill_trainer",
                                     "channel_drop", "channel_poison"),
            rate=0.6, targets=(0, 1, 2, 3, -1))
        return [dict(kind=e.kind, round=e.round, target=e.target)
                for e in plan.events]
    runs = []
    for _ in range(2):
        js, ts = _fleet_pair(events())
        _run_pair(js, ts, 5)
        _assert_same_fleet(js, ts)
        runs.append((ts.failures, ts.recoveries, ts.runner.trained_samples,
                     ts.runner.poisoned_samples, ts.runner.predictions))
    assert runs[0] == runs[1] and len(runs[0][0]) >= 2


def test_fleet_factories_run_without_jax():
    """``make_fleet_supervisor`` with a fault plan and the launcher's
    ``--online-controller`` on the CPU, in a process where importing JAX
    fails; both default to the card (and refuse to run without one), and
    the launcher refuses ``--online-controller`` without a layout."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import inspect\n"
        "from repro_torch.core.placement import plan_async\n"
        "from repro_torch.envs import make_env\n"
        "from repro_torch.fault import FaultEvent, FaultPlan\n"
        "from repro_torch.launch import steps\n"
        "from repro_torch.launch.async_a3c import main\n"
        "for f in (steps.make_async_runner,):\n"
        "    assert inspect.signature(f).parameters['device'].default "
        "== 'cuda'\n"
        "try:\n"
        "    steps.make_fleet_supervisor(make_env('Ant', device='cpu'), "
        "plan_async(3, 2, 2, devices=list(range(6)), devices_per_gpu=2, "
        "device='cpu'), num_envs=4, num_steps=2)\n"
        "    raise SystemExit('ran on the CPU by default')\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "layout = plan_async(3, 2, 2, devices=list(range(6)), "
        "devices_per_gpu=2, device='cpu')\n"
        "plan = FaultPlan([FaultEvent('kill_serving', 1), "
        "FaultEvent('channel_poison', 2)])\n"
        "sup = steps.make_fleet_supervisor(make_env('Ant', device='cpu'), "
        "layout, plan=plan, num_envs=4, num_steps=2, device='cpu')\n"
        "sup.run(4)\n"
        "r = sup.runner\n"
        "assert r.trained_samples + r.poisoned_samples == r.predictions\n"
        "assert [f['kind'] for f in sup.failures] == ['kill_serving', "
        "'channel_poison'], sup.summary()\n"
        "try:\n"
        "    main(['--rounds', '1', '--online-controller'])\n"
        "    raise SystemExit('--online-controller ran with no layout')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 2, e\n"
        "try:\n"
        "    main(['--rounds', '1', '--num-gpus', '2', '--serving-gpus', "
        "'1', '--gmi-per-gpu', '2', '--online-controller'])\n"
        "    raise SystemExit('the launcher ran on the CPU by default')\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "r = main(['--device', 'cpu', '--env', 'BallBalance', "
        "'--num-env', '8', '--rollout', '4', '--rounds', '6', "
        "'--num-gpus', '3', '--serving-gpus', '1', '--gmi-per-gpu', '2', "
        "'--overlap', '--online-controller', '--num-env-sweep', '8,16'])\n"
        "assert r.trained_samples == r.predictions and r.replans >= 1\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print('NO_JAX_OK')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    assert "NO_JAX_OK" in out.stdout
    assert "OnlineGMIController(" in out.stdout
    assert "re-plan: probe num_env=16" in out.stdout


# ------------------------------------------------------- the serving half --
def _serve_cfg():
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import transformer as JT
    from repro_torch.configs.base import ModelConfig
    kw = dict(name="f", num_layers=2, d_model=32, num_heads=2,
              num_kv_heads=2, d_ff=64, vocab_size=64)
    jp = JT.init_model(jax.random.key(0), JModelConfig(**kw))
    return ((JModelConfig(**kw), jp),
            (ModelConfig(**kw), interop.model_params(_np(jp))))


def _routers(fronts=True, prefill=2):
    """The reference's serving front and the port's from the same weights:
    2 decode engines behind a router (``fronts=False``) or, behind a
    ``DisaggFront``, 2 decode engines and ``prefill`` specialists with
    migration forced."""
    from repro import serve as jserve
    from repro_torch import serve as tserve
    out = {}
    for k, mod, (cfg, params), extra in (
            ("jax", jserve, _serve_cfg()[0], {}),
            ("torch", tserve, _serve_cfg()[1], {"device": "cpu"})):
        def efac(i, slots=2, mod=mod, cfg=cfg, params=params, extra=extra):
            return mod.ServeEngine(cfg, params, max_slots=slots, max_seq=32,
                                   name=f"d{i}", **extra)

        def pfac(i, mod=mod, cfg=cfg, params=params, extra=extra):
            return mod.PrefillEngine(cfg, params, max_seq=32, name=f"p{i}",
                                     **extra)

        router = mod.RequestRouter(engine_factory=efac, num_engines=2)
        out[k] = router if not fronts else mod.DisaggFront(
            router, [pfac(i) for i in range(prefill)],
            planner=mod.MigrationPlanner(bandwidth=1e15, latency_s=0.0,
                                         prefill_tok_s=1e-6),
            prefill_factory=pfac)
    return out


def _serve_requests(seed, n, gen=5):
    from repro.serve import Request as JRequest
    from repro_torch.serve import Request as TRequest
    rng = np.random.default_rng(seed)
    pairs = [(rng.integers(0, 64, 6), gen) for _ in range(n)]
    return {k: [R(tokens=t, max_new_tokens=b) for t, b in pairs]
            for k, R in (("jax", JRequest), ("torch", TRequest))}


SERVING_CASES = {
    "engine_fail": dict(events=[dict(kind="engine_fail", round=1,
                                     target=1)], fronts=False),
    "prefill_fail": dict(events=[dict(kind="prefill_fail", round=1,
                                      target=0)], fronts=True),
    "prefill_and_channel_drop": dict(
        events=[dict(kind="prefill_fail", round=1, target=0),
                dict(kind="channel_drop", round=1)], fronts=True),
}


@pytest.mark.parametrize("case", sorted(SERVING_CASES))
def test_supervised_serving_matches_reference(case):
    """The supervisor's serving half under both packages, after
    ``tests/test_fault_recovery.py``'s engine and prefill cases: a decode
    engine dies mid-decode behind a router, or a prefill specialist dies
    with a payload staged on the migration channel behind a
    ``DisaggFront`` (also with a channel drop in the same round, which the
    channel's own seam retransmits).  ``drain_serving`` completes every
    request with the reference's tokens; failure and recovery logs, engine
    counts and channel counters are equal."""
    kw = SERVING_CASES[case]
    fronts = _routers(fronts=kw["fronts"])
    reqs = _serve_requests(5, 8)
    sups, done = {}, {}
    for k, mod, make, plan_async, extra in (
            ("jax", jfault, jmake_fleet, jplan_async, {}),
            ("torch", tfault, tmake_fleet, tplan_async, {"device": "cpu"})):
        env = jax_make_env("Ant") if k == "jax" else \
            interop.env_like("Ant", jax_make_env("Ant").mega)
        layout = plan_async(3, 2, 2, devices=list(range(6)),
                            devices_per_gpu=2, **extra)
        f = fronts[k]
        sup = make(env, layout, plan=_events(mod, kw["events"]), router=f,
                   num_envs=N, num_steps=T, **extra)
        if kw["fronts"]:
            # a drop, when scheduled, hits the channel's seam
            f.channel.fault_hook = lambda src, item, sup=sup: (
                "drop" if sup.plan.take("channel_drop") is not None
                else None)
        for q in reqs[k]:
            f.submit(q)
        if kw["fronts"]:
            doomed = f.prefill_engines[0]
            payload = doomed.step()
            f.channel.send(payload, payload.cache, source=doomed)
        sup.plan.advance(1)
        idx = {r.rid: i for i, r in enumerate(reqs[k])}
        done[k] = {idx[c.rid]: (c.tokens, c.status)
                   for c in sup.drain_serving()}
        sups[k] = sup
    assert done["torch"] == done["jax"] and len(done["torch"]) == 8
    assert all(s == "ok" for _, s in done["torch"].values())
    js, ts = sups["jax"], sups["torch"]
    assert ts.failures == js.failures and ts.recoveries == js.recoveries
    tf, jf = fronts["torch"], fronts["jax"]
    if kw["fronts"]:
        assert [f["kind"] for f in ts.failures] == ["prefill_fail"]
        assert tf.failed_prefill_engines == jf.failed_prefill_engines == 1
        assert len(tf.prefill_engines) == len(jf.prefill_engines) == 1
        assert tf.channel.in_flight == jf.channel.in_flight == 0
        assert tf.channel.dropped == jf.channel.dropped \
            == (1 if "drop" in case else 0)
        assert tf.router.num_engines == jf.router.num_engines == 2
    else:
        assert [f["kind"] for f in ts.failures] == ["engine_fail"]
        assert tf.num_engines == jf.num_engines == 1
        assert tf.failed_engines == jf.failed_engines == 1


def test_engine_fail_behind_a_disagg_front():
    """ROADMAP C11: the reference's ``DisaggFront`` has no ``fail_engine``
    or ``num_engines``, so its supervisor raises AttributeError when a
    decode engine dies behind the front; the port's front delegates both
    to its router and fails the engine over losslessly, with the tokens
    the reference's router gives for the same requests."""
    fronts = _routers(fronts=True)
    reqs = _serve_requests(6, 6)
    plan = [dict(kind="engine_fail", round=1, target=0)]
    out = {}
    for k, mod, make, plan_async, extra in (
            ("jax", jfault, jmake_fleet, jplan_async, {}),
            ("torch", tfault, tmake_fleet, tplan_async, {"device": "cpu"})):
        env = jax_make_env("Ant") if k == "jax" else \
            interop.env_like("Ant", jax_make_env("Ant").mega)
        layout = plan_async(3, 2, 2, devices=list(range(6)),
                            devices_per_gpu=2, **extra)
        f = fronts[k]
        sup = make(env, layout, plan=_events(mod, plan), router=f,
                   num_envs=N, num_steps=T, **extra)
        for q in reqs[k]:
            f.submit(q)
        sup.step_serving()              # prefills migrate, decode starts
        sup.plan.advance(1)
        if k == "jax":
            with pytest.raises(AttributeError, match="fail_engine"):
                sup.drain_serving()
            continue
        idx = {r.rid: i for i, r in enumerate(reqs[k])}
        out = {idx[c.rid]: (c.tokens, c.status)
               for c in list(f.completions) + sup.drain_serving()}
        assert [x["kind"] for x in sup.failures] == ["engine_fail"]
        assert f.num_engines == 1 and f.router.failed_engines == 1
    assert len(out) == 6 and all(s == "ok" for _, s in out.values())
    # the same requests through the reference's plain router, no fault
    jr = _routers(fronts=False)["jax"]
    for q in _serve_requests(6, 6)["jax"]:
        jr.submit(q)
    want = sorted(c.tokens for c in jr.drain())
    assert sorted(t for t, _ in out.values()) == want
