"""Parity of the port's online GMI controller (runtime Algorithm 2) with
the JAX package on the CPU.  Both packages' controllers are driven through
the same ``RoundSample`` and ``ServingLoad`` sequences (the scenarios of
``tests/test_controller.py``, the controller cases of ``tests/test_comm.py``
and the serving ones of ``tests/test_serve_router.py`` and
``tests/test_disagg.py``) and must give equal ``Decision`` lists, equal
``state_dict()`` JSON and equal summaries.  Then ``observe_pipeline`` over
each package's pipeline, ``plan_layout``, and an ``AsyncRunner`` re-planning
under the controller in both packages, round by round.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.core import controller as jctl
from repro.core.channels import MultiChannelPipeline as JPipe
from repro.envs import make_env as jax_make_env
from repro.launch import steps as jsteps
from repro.rl import a3c as ja3c
from repro.rl.a3c import Experience as JExp
from repro.rl.rollout import collect as jcollect
from repro.serve import telemetry as jtel
from repro_torch import comm as tcomm
from repro_torch import interop
from repro_torch.checkpoint.ckpt import keystr_leaves
from repro_torch.core import controller as tctl
from repro_torch.core import placement as tplace
from repro_torch.core.channels import MultiChannelPipeline as TPipe
from repro_torch.launch import steps as tsteps
from repro_torch.rl.a3c import Experience as TExp
from repro_torch.serve import telemetry as ttel

PKGS = {"jax": (jctl, jtel, jcomm), "torch": (tctl, ttel, tcomm)}


def _r(samples=1000, dt=0.1, occ=0.5, spills=0, mem=1e6, reduce_s=0.0):
    return ("r", dict(samples=samples, dt=dt, occupancy=occ, spills=spills,
                      mem_bytes=mem, reduce_s=reduce_s))


def _s(backlog=0, occ=0.5, q=0.0, qmax=0, tokens=100, dt=1.0, slots=4,
       p95=0.05, pf_backlog=0, migrations=0):
    return ("s", dict(dt=dt, tokens=tokens, requests=4, queue_depth_mean=q,
                      queue_depth_max=qmax, occupancy_mean=occ,
                      backlog=backlog, p50_s=p95 / 2, p95_s=p95,
                      slots=slots, prefill_backlog=pf_backlog,
                      migrations=migrations))


BASE = dict(num_gpu=4, serving_gpus=2, gmi_per_gpu=2, num_env=512)
# name: (constructor overrides, ControllerConfig kwargs, ops)
SCENARIOS = {
    "epoch_boundary": ({}, dict(epoch_rounds=3), [_r(), _r(), _r()]),
    "ring_pressure": ({}, dict(epoch_rounds=1, probe=False),
                      [_r(occ=1.0, spills=2)]),
    "last_serving_kept": (dict(serving_gpus=1),
                          dict(epoch_rounds=1, probe=False, occ_low=0.0),
                          [_r(occ=1.0, spills=5)]),
    "full_ring_not_pressure": ({}, dict(epoch_rounds=1, probe=False),
                               [_r(occ=1.0)]),
    "starvation": (dict(serving_gpus=1), dict(epoch_rounds=1, probe=False),
                   [_r(occ=0.05)]),
    "probe_ladder": (dict(num_gpu=2, serving_gpus=1), dict(epoch_rounds=1),
                     [_r(samples=4000), _r(samples=2000, mem=2e6),
                      _r(samples=4000)]),
    "hysteresis": (dict(num_gpu=2, serving_gpus=1),
                   dict(epoch_rounds=1, probe=False, min_gain=1.5),
                   [_r(samples=4000), ("set", "num_env", 1024),
                    _r(samples=4400, mem=2e6), ("set", "num_env", 512),
                    _r(samples=4000)]),
    "running_mean": ({}, dict(epoch_rounds=1, probe=False, occ_low=0.0),
                     [_r(samples=1000, dt=1.0), _r(samples=3000, dt=1.0)]),
    "long_mixed": (dict(num_gpu=4, serving_gpus=1, num_env=128),
                   dict(epoch_rounds=2, num_env_sweep=(128, 256, 512)),
                   [_r(samples=s, dt=d, occ=o, spills=k, mem=m)
                    for s, d, o, k, m in [
                        (900, 0.1, 0.1, 0, 1e6), (1100, 0.1, 0.2, 0, 1e6),
                        (2500, 0.2, 0.9, 0, 2e6), (2600, 0.2, 1.0, 1, 2e6),
                        (3000, 0.1, 1.0, 0, 3e6), (2000, 0.3, 0.5, 0, 3e6),
                        (100, 0.0, 0.5, 0, 1e6), (0, 0.1, 0.5, 0, 1e6),
                        (5000, 0.1, 1.0, 3, 4e6), (5000, 0.1, 1.0, 0, 4e6)]]
                   + [("set", "num_env", 256)]
                   + [_r(samples=7000, dt=0.1, mem=5e6)] * 2),
    # serving half
    "serving_max_split_probe": (dict(num_gpu=3, serving_gpus=2,
                                     gmi_per_gpu=1, num_env=64),
                                dict(epoch_rounds=1),
                                [_s(backlog=3, occ=1.0, q=5.0, qmax=6),
                                 _s()]),
    "serving_probe_skips_measured": (dict(num_gpu=3, serving_gpus=2,
                                          gmi_per_gpu=1, num_env=64),
                                     dict(epoch_rounds=1),
                                     [_s(slots=4), _s(slots=8, tokens=500),
                                      _s(slots=4, backlog=3, occ=1.0, q=5.0,
                                         qmax=6)]),
    "serving_backlog_grows": (dict(num_gpu=4, serving_gpus=1, gmi_per_gpu=2,
                                   num_env=64), dict(epoch_rounds=1),
                              [_s(backlog=4, occ=1.0, q=6.0, qmax=9,
                                  slots=4)] * 3),
    "serving_transient_backlog": (dict(num_gpu=4, serving_gpus=1,
                                       gmi_per_gpu=1, num_env=64),
                                  dict(epoch_rounds=2),
                                  [_s(backlog=2, occ=1.0), _s(occ=0.6)]),
    "serving_idle": (dict(num_gpu=4, serving_gpus=2, gmi_per_gpu=1,
                          num_env=64), dict(epoch_rounds=1),
                     [_s(occ=0.0, tokens=0, dt=0.0), _s(occ=0.1),
                      _s(occ=0.0, tokens=0, dt=0.0)]),
    "serving_explore": (dict(num_gpu=4, serving_gpus=2, gmi_per_gpu=1,
                             num_env=64), dict(epoch_rounds=1),
                        [_s(slots=4), _s(slots=16, tokens=500), _s(slots=4)]),
    "prefill_arbitration": (dict(num_gpu=6, serving_gpus=4, gmi_per_gpu=1,
                                 num_env=8), dict(epoch_rounds=1),
                            [("set", "prefill_gpus", 1),
                             _s(pf_backlog=3, migrations=2), _s(),
                             _s(backlog=2, occ=1.0, pf_backlog=1)]),
    "aggregated_no_prefill": (dict(num_gpu=6, serving_gpus=4, gmi_per_gpu=1,
                                   num_env=8), dict(epoch_rounds=1), [_s()]),
    "rollout_and_serving": (dict(num_gpu=4, serving_gpus=1, gmi_per_gpu=2,
                                 num_env=128),
                            dict(epoch_rounds=1,
                                 num_env_sweep=(128, 256)),
                            [_r(samples=2000, occ=0.1), _s(backlog=3,
                                                           occ=1.0, q=4.0,
                                                           qmax=5),
                             _r(samples=2500), _s(occ=0.0, tokens=0,
                                                  dt=0.0)]),
}


def _make(pkg, ctor, cfg, comm=None):
    ctl = PKGS[pkg][0]
    return ctl.OnlineGMIController(cfg=ctl.ControllerConfig(**cfg),
                                   communicator=comm, **{**BASE, **ctor})


def _drive(pkg, c, ops):
    ctl, tel, _ = PKGS[pkg]
    out = []
    for op in ops:
        if op[0] == "set":
            setattr(c, op[1], op[2])
            d = None
        elif op[0] == "r":
            d = c.record(ctl.RoundSample(**op[1]))
        else:
            d = c.observe_serving(tel.ServingLoad(**op[1]))
        out.append(None if d is None else dataclasses.asdict(d))
    return out


def _same(cj, ct):
    assert json.dumps(ct.state_dict()) == json.dumps(cj.state_dict())
    assert ct.summary() == cj.summary()
    assert [dataclasses.asdict(d) for d in ct.decisions] \
        == [dataclasses.asdict(d) for d in cj.decisions]
    assert ct.propose_probe() == cj.propose_probe()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_decisions_match_reference(name):
    ctor, cfg, ops = SCENARIOS[name]
    cj, ct = _make("jax", ctor, cfg), _make("torch", ctor, cfg)
    got = _drive("torch", ct, ops)
    assert got == _drive("jax", cj, ops)
    _same(cj, ct)
    pj, pt = cj.recorded_profile(), ct.recorded_profile()
    for key in [(g, ne) for g in (1, 2) for ne in (128, 256, 512, 1024)]:
        assert vars(pt("live", *key)) == vars(pj("live", *key))


def test_state_dict_crosses_packages_and_resumes_the_same():
    """A reference controller's learned state loads into the port's (and
    back); both then decide the same on the same further rounds."""
    ctor, cfg, ops = SCENARIOS["long_mixed"]
    cj = _make("jax", ctor, cfg)
    _drive("jax", cj, ops[:8])          # an epoch boundary
    state = json.loads(json.dumps(cj.state_dict()))
    ct = _make("torch", dict(num_gpu=2, serving_gpus=1, gmi_per_gpu=1,
                             num_env=8), cfg)
    ct.load_state_dict(state)
    assert json.dumps(ct.state_dict()) == json.dumps(cj.state_dict())
    assert _drive("torch", ct, ops[8:]) == _drive("jax", cj, ops[8:])
    back = _make("jax", {}, cfg)
    back.load_state_dict(json.loads(json.dumps(ct.state_dict())))
    assert json.dumps(back.state_dict()) == json.dumps(ct.state_dict())


# ------------------------------------------- the communicator in the loop --
def _truth(comm):
    return comm.ReduceCostModel(bw_intra=400e9, bw_gpu=5e9, bw_dev=50e9,
                                bytes_per_round=6e6, dev_per_inst=2)


def _comm_case(name, comm):
    cm = comm.ReduceCostModel(dev_per_inst=2, bytes_per_round=6e6)
    if name == "calibrated":
        c = comm.Communicator("har3", grid=(2, 2, 2), cost_model=cm,
                              calibrate=True)
        truth = _truth(comm)
        for s in c.candidates():
            for _ in range(3):
                c.observe(truth.time(s, (2, 2, 2)), 6e6, strategy=s)
        for _ in range(2):
            c.observe_transfer(1e6 / truth.bw_intra, 1e6)
        return c, dict(epoch_rounds=1, probe=False), [_r()]
    strategy = "har3" if name == "best_no_switch" else "mpr"
    c = comm.Communicator(strategy, grid=(2, 2, 2), cost_model=cm,
                          calibrate=name == "calibration_probe")
    if name != "reduce_s":
        for _ in range(3):
            c.observe(1.0)
    cfg = dict(epoch_rounds=1, probe=False)
    if name == "calibration_probe":
        cfg = dict(epoch_rounds=1, min_gain=1e9, probe=True,
                   num_env_sweep=(512,))
    if name == "reduce_s":
        cfg = dict(epoch_rounds=2, probe=False)
        return c, cfg, [_r(reduce_s=0.5), _r(reduce_s=0.25), _r(reduce_s=2.0),
                        _r(reduce_s=2.0)]
    return c, cfg, [_r(), _r()]


@pytest.mark.parametrize("name", ["slow_mpr_switch", "best_no_switch",
                                  "calibration_probe", "calibrated",
                                  "reduce_s"])
def test_controller_with_communicator_matches_reference(name):
    """The reduction-strategy half of the decision (``tests/test_comm.py``'s
    controller cases): switch, hysteresis, calibration probe, calibrated
    bandwidths, and ``RoundSample.reduce_s`` feeding the communicator."""
    out = {}
    for pkg in ("jax", "torch"):
        c, cfg, ops = _comm_case(name, PKGS[pkg][2])
        ctl = _make(pkg, {}, cfg, comm=c)
        out[pkg] = (_drive(pkg, ctl, ops), ctl, c)
    (dj, cj, mj), (dt_, ct, mt) = out["jax"], out["torch"]
    assert dt_ == dj
    _same(cj, ct)
    assert repr(mt) == repr(mj)
    assert mt.measurements() == mj.measurements()
    first = next(d for d in dj if d is not None) if any(dj) else None
    want = {"slow_mpr_switch": "har3", "best_no_switch": None,
            "calibration_probe": ("har", "har3"), "calibrated": "mpr",
            "reduce_s": "har3"}[name]
    got = None if first is None else first["reduction_strategy"]
    assert got in want if isinstance(want, tuple) else got == want


def _jexp(v):
    import jax.numpy as jnp
    return JExp(obs=jnp.zeros((2, 4, 3)), actions=jnp.zeros((2, 4, 2)),
                rewards=jnp.zeros((2, 4)), dones=jnp.zeros((2, 4)),
                bootstrap=jnp.zeros((4,)), actor_version=jnp.int32(v))


def _texp(v):
    return TExp(obs=torch.zeros((2, 4, 3)), actions=torch.zeros((2, 4, 2)),
                rewards=torch.zeros((2, 4)), dones=torch.zeros((2, 4)),
                bootstrap=torch.zeros((4,)),
                actor_version=torch.tensor(v, dtype=torch.int32))


def test_observe_pipeline_over_each_packages_pipeline():
    """Occupancy, spill and byte deltas read off a real pipeline, the
    marks reset on a fresh (re-planned) pipeline, transfer samples
    forwarded to a calibrating communicator: the same in both packages."""
    res = {}
    for pkg, Pipe, exp in (("jax", JPipe, _jexp), ("torch", TPipe, _texp)):
        comm = PKGS[pkg][2].Communicator("mpr", grid=(2, 2), calibrate=True)
        c = _make(pkg, {}, dict(epoch_rounds=10), comm=comm)
        pipe = Pipe([0], [9], overlap=True)
        pipe.push(0, exp(0))
        pipe.push(0, exp(1))                     # spill (1-slot ring)
        pipe.flush()
        pipe.flush()
        assert c.observe_pipeline(pipe, samples=8, dt=0.1) is None
        pipe2 = Pipe([0], [9], overlap=True)
        pipe2.push(0, exp(2))
        pipe2.flush()
        c.observe_pipeline(pipe2, samples=8, dt=0.1)
        res[pkg] = ([dataclasses.asdict(s) for s in c._epoch],
                    comm.calibrator.transfer_count)
    assert res["torch"] == res["jax"]
    assert res["torch"][0][0]["spills"] == 1
    assert res["torch"][0][1]["spills"] == 0


def test_plan_layout_matches_reference():
    for serving in (1, 2, 3):
        lays = []
        for ctl, kw in ((jctl, {}), (tctl, {"device": "cpu"})):
            c = ctl.OnlineGMIController(num_gpu=4, serving_gpus=serving,
                                        gmi_per_gpu=2, num_env=64)
            lay = c.plan_layout(devices=list(range(8)), devices_per_gpu=2,
                                **kw)
            lays.append((lay.name, lay.serving_gmis, lay.trainer_gmis,
                         {g: (v.gpu_id, v.role, list(v.device_ids))
                          for g, v in lay.manager.gmis.items()}))
        assert lays[0] == lays[1]


# -------------------------------------------------- the runner re-planning --
def _fixed_dt(ctl):
    """Round wall times are host noise: hold them at 1.0 s in both
    packages so the controllers see the same evidence."""
    observe = ctl.observe_pipeline
    ctl.observe_pipeline = lambda pipe, samples, dt: observe(pipe, samples,
                                                             1.0)


def test_async_runner_replans_under_the_controller_as_reference(monkeypatch):
    """``make_async_runner(..., overlap=True, online_controller=True)`` in
    both packages, round by round from carried params and env states with
    replayed noise: the probe re-plan up the num_env ladder, then the
    measured decision, the same in both; losses to 1e-4, params to 1e-5,
    nothing lost across the re-plans."""
    monkeypatch.setattr(ja3c, "collect",
                        jax.jit(jcollect, static_argnums=(1, 5)))
    from repro.core.placement import plan_async as jplan
    jenv = jax_make_env("Ant")
    tenv = interop.env_like("Ant", jenv.mega)
    runners = []
    for steps, env, plan_async, ctl, kw in (
            (jsteps, jenv, jplan, jctl, {}),
            (tsteps, tenv, tplace.plan_async, tctl, {"device": "cpu"})):
        layout = plan_async(4, 2, 2, devices=list(range(8)),
                            devices_per_gpu=2, **kw)
        r = steps.make_async_runner(
            env, layout, overlap=True, online_controller=True,
            controller_cfg=ctl.ControllerConfig(epoch_rounds=2, occ_low=0.0,
                                                num_env_sweep=(4, 8)),
            num_envs=4, num_steps=2, **kw)
        _fixed_dt(r.controller)
        runners.append(r)
    jr, tr = runners
    tr.params = interop.policy_params(jax.tree.map(np.array, jr.params))
    tr.opt_state = interop.adam_state(jax.tree.map(np.array, jr.opt_state))
    tr.actor_params = tr.params

    def carry():
        for a, (es, obs, _) in jr.actors.items():
            tr.actors[a] = [interop.env_state(jax.tree.map(np.array, es)),
                            torch.as_tensor(np.array(obs)), tr.actors[a][2]]

    def noise(a):
        key, draws = jr.actors[a][2], []
        for _ in range(jr.num_steps):
            key, akey = jax.random.split(key)
            draws.append(np.array(jax.random.normal(
                akey, (jr.num_envs, jr.env.spec.act_dim))))
        return torch.as_tensor(np.stack(draws))

    carry()
    for _ in range(7):
        replans = jr.replans
        nz = {a: noise(a) for a in jr.serving_gmis}
        jl, js = jr.round()
        tl, ts = tr.round(nz)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        assert ts == js and tr.replans == jr.replans
        assert (tr.num_envs, tr.serving_gmis) == (jr.num_envs,
                                                  jr.serving_gmis)
        if jr.replans != replans:
            carry()
    jl, js = jr.finish()
    tl, ts = tr.finish()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert tr.replans >= 1
    assert any("probe" in d.reason for d in tr.controller.decisions)
    _same(jr.controller, tr.controller)
    assert tr.trained_samples == tr.predictions == jr.predictions
    assert tr.version == int(jr.version)
    for (_, g), (_, w) in zip(keystr_leaves(tr.params),
                              keystr_leaves(jax.tree.map(np.array,
                                                         jr.params))):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)
