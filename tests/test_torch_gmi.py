"""Parity of the port's GMI control plane with the JAX package on the CPU:
the GMI manager and the five placement templates (integer bookkeeping,
exact), the instance grid, the same errors; and the slice as a whole — a
2 x 2 TCG_EX run of synchronous PPO, each GMI's noise and permutations
replayed from the reference's keys, params averaged after every
iteration on both sides — and the launcher in a process without JAX.
"""
import os
import re
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.core import gmi as jgmi
from repro.core import placement as jplace
from repro.envs import suite as jsuite
from repro.envs import make_env as jax_make_env
from repro.rl import ppo as jppo
from repro_torch import interop, utils
from repro_torch.core import gmi as tgmi
from repro_torch.core import placement as tplace
from repro_torch.rl import ppo as tppo

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_adam import (B1, B2, EPS, GRAD_RTOL, LR,  # noqa: E402
                         adam_slack, grad_share, record_adam)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# (template, its size arguments, the logical device count per GPU)
TEMPLATES = [
    ("plan_tcg_serving", (g, t), t) for g, t in ((1, 1), (2, 3), (1, 4))
] + [
    ("plan_tdg_serving", (g, p), 10) for g, p in ((1, 1), (2, 2))
] + [
    ("plan_tcg_ex_training", (g, t), t)
    for g, t in ((1, 1), (1, 4), (2, 2), (2, 3), (4, 2))
] + [
    ("plan_tdg_ex_training", (g, s, t), 20) for g, s, t in ((1, 2, 1),
                                                            (2, 2, 2))
] + [
    ("plan_async", (g, s, t), t) for g, s, t in ((2, 1, 2), (4, 2, 2),
                                                 (3, 1, 3))
]


def _layout_facts(layout):
    mgr = layout.manager
    gmis = [(g.gmi_id, g.role, g.device_ids, g.gpu_id, g.backend,
             g.resource_fraction, g.group, g.num_devices)
            for g in sorted(mgr.gmis.values(), key=lambda x: x.gmi_id)]
    roles = sorted({g.role for g in mgr.gmis.values()})
    return (layout.name, layout.serving_gmis, layout.trainer_gmis,
            layout.mpl, layout.reduction_strategy(), mgr.summary(), gmis,
            mgr.gmi_to_gpu_mapping(),
            {r: mgr.gmi_to_gpu_mapping(r) for r in roles})


@pytest.mark.parametrize("name,args,per_gpu", TEMPLATES,
                         ids=[f"{n}{a}" for n, a, _ in TEMPLATES])
def test_templates_match_reference(name, args, per_gpu):
    """Every template with synthetic ids: the same GMIs (roles, device ids,
    GPUs, fractions), mappings, MPL, Algorithm-1 strategy and summary
    text."""
    g = args[0]
    kw = dict(devices=list(range(g * per_gpu)), devices_per_gpu=per_gpu)
    want = _layout_facts(getattr(jplace, name)(*args, **kw))
    got = _layout_facts(getattr(tplace, name)(*args, **kw))
    assert got == want


def test_plan_async_needs_a_training_gpu():
    for mod in (jplace, tplace):
        with pytest.raises(ValueError, match="at least one training GPU"):
            mod.plan_async(2, 2, 1, devices=list(range(4)),
                           devices_per_gpu=2)


def _manager(mod, n, per_gpu, **kw):
    return mod.GMIManager(devices=list(range(n)), devices_per_gpu=per_gpu,
                          **kw)


def _raises_same(fn_ref, fn_port):
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as want:
        fn_ref()
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        fn_port()


def test_manager_registration_and_errors_match_reference():
    """tests/test_core_gmi.py's registration, duplicate id and overcommit
    cases: the same mapping, and the same ValueErrors."""
    mgrs = [_manager(jgmi, 8, 4), _manager(tgmi, 8, 4, device="cpu")]
    for mgr in mgrs:
        for gid, gpu in [(0, 0), (1, 0), (2, 1), (3, 1)]:
            mgr.add_gmi(gid, "trainer", 0.5)
            mgr.set_gpu(gid, gpu)
        assert mgr.get_group(0, "trainer") == "trainer"
    assert mgrs[1].gmi_to_gpu_mapping("trainer") == \
        mgrs[0].gmi_to_gpu_mapping("trainer") == [[0, 1], [2, 3]]
    assert mgrs[1].groups == mgrs[0].groups
    assert mgrs[1].gmis[0].num_devices == 2
    _raises_same(lambda: mgrs[0].add_gmi(0), lambda: mgrs[1].add_gmi(0))
    for mgr in mgrs:
        mgr.add_gmi(9, "trainer", 0.75)
    _raises_same(lambda: mgrs[0].set_gpu(9, 0), lambda: mgrs[1].set_gpu(9, 0))
    assert mgrs[1].summary() == mgrs[0].summary()


def _grid_case(mod, case, **kw):
    if case == "multi_device":
        mgr = _manager(mod, 8, 4, **kw)
        for gid, gpu in [(0, 0), (1, 0), (2, 1), (3, 1)]:
            mgr.add_gmi(gid, "trainer", 0.5)
            mgr.set_gpu(gid, gpu)
        return mgr
    if case == "single_device":
        return mod.plan_tcg_ex_training(2, 3, devices=list(range(6)),
                                        devices_per_gpu=3, **kw).manager
    mgr = _manager(mod, 8, 4, **kw)
    if case == "mixed":
        mgr.add_gmi(0, "trainer", 0.5)
        mgr.set_gpu(0, 0)
        mgr.add_gmi(1, "trainer", 0.25)
        mgr.set_gpu(1, 1)
    elif case == "ragged":
        for gid, gpu in [(0, 0), (1, 1), (2, 1)]:
            mgr.add_gmi(gid, "trainer", 0.25)
            mgr.set_gpu(gid, gpu)
    elif case == "unattached":
        mgr.add_gmi(0, "trainer", 0.25)
    return mgr


@pytest.mark.parametrize("case", ["single_device", "multi_device"])
def test_instance_grid_matches_reference_mesh(case):
    """The grid's shape, axis names (with the trailing ``dev`` axis of
    resized GMIs) and device ids equal the reference mesh's; one context
    per GMI, on the manager's device."""
    role = "trainer" if case == "multi_device" else "holistic"
    mesh = _grid_case(jgmi if case == "multi_device" else jplace,
                      case).instance_mesh(role)
    grid = _grid_case(tgmi if case == "multi_device" else tplace, case,
                      device="cpu").instance_mesh(role)
    assert grid.shape == tuple(mesh.devices.shape)
    assert grid.axis_names == tuple(mesh.axis_names)
    np.testing.assert_array_equal(grid.devices.astype(np.int64),
                                  mesh.devices.astype(np.int64))
    assert len(grid.contexts) == grid.gmi_ids.size
    assert all(c.device == torch.device("cpu") and c.stream is None
               for c in grid.contexts)
    if case == "multi_device":
        assert sorted(grid.devices.reshape(-1).tolist()) == list(range(8))


@pytest.mark.parametrize("case,role", [("mixed", "trainer"),
                                       ("ragged", "trainer"),
                                       ("unattached", "trainer"),
                                       ("ragged", "serving")])
def test_instance_grid_errors_match_reference(case, role):
    """Mixed device counts, a ragged layout, GMIs with no devices and a
    role with no GMIs: the reference's ValueErrors."""
    _raises_same(lambda: _grid_case(jgmi, case).instance_mesh(role),
                 lambda: _grid_case(tgmi, case,
                                    device="cpu").instance_mesh(role))


def test_instance_grid_rejects_dev_in_axes_and_defaults_to_cuda():
    """``axes`` may not name ``dev`` for resized GMIs; without a card the
    default device raises when a grid or a GMI's context is asked for,
    while the integer bookkeeping needs no card."""
    mgr = _grid_case(tgmi, "multi_device", device="cpu")
    with pytest.raises(ValueError, match="may not already contain 'dev'"):
        mgr.instance_mesh("trainer", axes=("gpu", "dev"))
    ctx = mgr.submesh(1)
    assert ctx.device == torch.device("cpu") and ctx.stream is None
    with ctx.scope():
        pass
    lay = tplace.plan_tcg_ex_training(1, 2, devices=list(range(2)),
                                      devices_per_gpu=2)
    assert lay.manager.device == torch.device("cuda")
    assert lay.reduction_strategy() == "mpr"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lay.manager.instance_mesh("holistic")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lay.manager.submesh(0)


def test_drl_role_and_paper_policies_match_reference():
    """Listing 1's DRLRole registers, attaches and groups as the
    reference's; POLICY_DIMS equal."""
    from repro.configs.paper_policies import POLICY_DIMS as JDIMS
    from repro_torch.configs.paper_policies import POLICY_DIMS as TDIMS
    assert TDIMS == JDIMS
    mgrs = [_manager(jgmi, 4, 2), _manager(tgmi, 4, 2, device="cpu")]
    roles = [[mod.DRLRole(m, i, "agent", i // 2, 0.5) for i in range(4)]
             for mod, m in zip((jgmi, tgmi), mgrs)]
    assert [(r.gmi_id, r.role, r.group) for r in roles[1]] == \
        [(r.gmi_id, r.role, r.group) for r in roles[0]]
    assert mgrs[1].summary() == mgrs[0].summary()
    with pytest.raises(NotImplementedError):
        roles[1][0].gmi_run()


# ----------------------------------------------- the slice as a whole ----
DIMS = (60, 32, 16, 8)        # Ant obs/act with a narrow trunk


def _np(x):
    return jax.tree.map(np.array, x)


def _replay(key, T, N, act, epochs):
    """The reference's key schedule of one train_iteration: per collect
    step ``key, akey = split(key)``; per epoch ``key, pkey = split(key)``
    (tests/test_torch_ppo.py)."""
    noise = []
    for _ in range(T):
        key, akey = jax.random.split(key)
        noise.append(np.array(jax.random.normal(akey, (N, act))))
    perms = []
    for _ in range(epochs):
        key, pkey = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(pkey, T * N)))
    return torch.as_tensor(np.stack(noise)), torch.as_tensor(np.stack(perms))


# sensor-matrix seeds (the reference's ``abs(hash("Ant")) % 2**31``):
# CRC-32 of the name, and three draws in which a GMI's first Adam step on
# some weight is ill-conditioned (its gradient a few EPS); in the last
# the averaged params differ by 3.8e-6, over the atol of 2e-6
SENSOR_DRAWS = [zlib.crc32(b"Ant"), 1367864807, 1109584190, 1546753293]


def _multi_gmi_run(monkeypatch, sensor_seed):
    """Both packages through two iterations of a 2 x 2 TCG_EX layout of
    Ant (see the test).  Metrics and bookkeeping are asserted here; the
    returned readings (with the Adam records), per iteration, are the largest gradient difference
    as a share of its leaf's largest gradient and, per params leaf, ``|port - reference|`` and
    Adam's slack so far (``adam_slack``)."""
    monkeypatch.setattr(jsuite, "hash", lambda s: sensor_seed,
                        raising=False)
    rec = {"j": [], "t": []}
    record_adam(monkeypatch, rec)
    g, t, N, T, seed = 2, 2, 8, 6, 0
    n = g * t
    jlay = jplace.plan_tcg_ex_training(g, t, devices=list(range(n)),
                                       devices_per_gpu=t)
    tlay = tplace.plan_tcg_ex_training(g, t, devices=list(range(n)),
                                       devices_per_gpu=t, device="cpu")
    assert tlay.communicator().strategy == jlay.communicator().strategy
    grid = tlay.manager.instance_mesh("holistic")
    assert grid.shape == (g, t) and len(grid.contexts) == n
    jcfg = jppo.PPOConfig(num_steps=T, num_epochs=2, num_minibatches=2,
                          use_fused_kernels=True)
    assert jcfg.lr == LR
    tcfg = tppo.PPOConfig(**jcfg._asdict())
    jenv = jax_make_env("Ant", megakernel=True)
    tenv = interop.env_like("Ant", jenv.mega, True)
    keys = jax.random.split(jax.random.key(seed), n)
    js, ts = [], []
    for i in range(n):
        p, o, es, ob = jppo.init_train(keys[i], jenv, DIMS, num_envs=N)
        js.append([p, o, es, ob, jax.random.PRNGKey(seed + i)])
        ts.append([interop.policy_params(_np(p)),
                   interop.adam_state(_np(o)), interop.env_state(_np(es)),
                   torch.as_tensor(np.array(ob))])
    readings = []
    for it in range(2):
        jm, tm = [], []
        for i in range(n):
            noise, perms = _replay(js[i][4], T, N, 8, jcfg.num_epochs)
            *js[i], m = _jstep(js[i], jenv, jcfg)
            jm.append(m)
            out = tppo.train_iteration(ts[i][0], ts[i][1], tenv, ts[i][2],
                                       ts[i][3], None, tcfg, noise=noise,
                                       perms=perms)
            ts[i] = [out[0], out[1], out[2], out[3]]
            tm.append(out[5])
        jmean = jax.tree.map(lambda *xs: sum(xs) / n, *[s[0] for s in js])
        tmean = utils.tree_map(lambda *xs: sum(xs) / n, *[s[0] for s in ts])
        for i in range(n):
            js[i][0], ts[i][0] = jmean, tmean
        for a, b in zip(tm, jm):
            for k in b:
                np.testing.assert_allclose(float(a[k]), float(b[k]),
                                           rtol=1e-5, atol=1e-5, err_msg=k)
        for i in range(n):
            for f in ("t", "seed", "resets"):
                np.testing.assert_array_equal(
                    getattr(ts[i][2], f).numpy(),
                    np.asarray(getattr(js[i][2], f)), err_msg=f)
            assert int(ts[i][1].step) == int(js[i][1].step) == 4 * (it + 1)
        assert len(rec["j"]) == len(rec["t"]) == 16 * (it + 1)
        grad = grad_share(rec["j"], rec["t"])
        diff = [np.abs(a.numpy() - b) for a, b in
                zip(utils.tree_leaves(tmean), jax.tree.leaves(_np(jmean)))]
        readings.append((grad, diff, adam_slack(rec["j"], rec["t"], n, LR,
                                                B1, B2, EPS)))
    return readings, rec


@pytest.mark.parametrize("sensor_seed", SENSOR_DRAWS)
def test_multi_gmi_ppo_matches_reference(monkeypatch, sensor_seed):
    """A 2 x 2 TCG_EX layout of Ant, 8 envs a GMI, T = 6, 2 iterations on
    the fused path (megakernel env, fused trunk and GAE).  The reference
    runs ``train_iteration`` per GMI from ``keys[i]`` and
    ``PRNGKey(seed + i)`` as its ``run_drl`` does; the port runs it from
    the same state with each GMI's noise and permutations replayed; both
    average the params after every iteration.  Metrics within 1e-5, env
    bookkeeping exact; every Adam update's gradients within GRAD_RTOL of
    the leaf's largest; the averaged params within atol 2e-6 plus
    what Adam makes of those gradient differences (``adam_slack``).

    The slack is the cause of ROADMAP C10: where a weight's gradient is a
    few EPS, Adam's step ``LR * g / (|g| + EPS)`` turns the gradient's
    float noise (~1e-9) into ~1e-6 of one GMI's params.  It is ~1e-9
    wherever the gradient is larger.  The reference seeds its sensor
    matrix from Python's per-process string hash (ROADMAP C5); here the
    seed is set, one case a draw (``SENSOR_DRAWS``)."""
    readings, _ = _multi_gmi_run(monkeypatch, sensor_seed)
    for it, (grad, diff, slack) in enumerate(readings):
        assert grad <= GRAD_RTOL, (it, grad)
        for d, s in zip(diff, slack):
            over = d - (2e-6 + s)
            assert over.max() <= 0, (it, float(d.max()), float(s.max()))


def _jstep(state, env, cfg):
    p, o, es, ob, k = state
    return jppo.train_iteration(p, o, env, es, ob, k, cfg)


@pytest.mark.parametrize("resume", [False, True])
def test_train_gmis_matches_a_plain_loop(resume):
    """``launch.steps.train_gmis`` (the launchers' multi-GMI loop) on the
    CPU equals a plain loop of the same steps with the params averaged
    after every iteration, bit for bit, whether it runs its iterations in
    one call or carries the GMIs from ``init_gmis`` on over one call an
    iteration; metrics and timings come back per iteration."""
    from repro_torch.envs import make_env
    from repro_torch.launch.steps import (init_gmis, make_drl_train_step,
                                          train_gmis)
    n, N, T, iters = 4, 8, 4, 2
    env = make_env("Ant", megakernel=True, device="cpu")
    cfg = tppo.PPOConfig(num_steps=T, num_epochs=2, num_minibatches=2,
                         use_fused_kernels=True)
    step, cfg = make_drl_train_step(env, cfg)
    lay = tplace.plan_tcg_ex_training(2, 2, devices=list(range(n)),
                                      devices_per_gpu=2, device="cpu")
    grid = lay.manager.instance_mesh("holistic")
    if resume:
        gmis = init_gmis(grid, env, n * N, seed=3)
        outs = [train_gmis(grid, env, step, T, n * N, 1, states=gmis)
                for _ in range(iters)]
        out = dict(outs[-1], metrics=[m for o in outs for m in o["metrics"]],
                   iter_s=[s for o in outs for s in o["iter_s"]])
    else:
        out = train_gmis(grid, env, step, T, n * N, iters, seed=3)
    states = [list(tppo.init_train(3 + i, env, env.spec.policy_dims, N,
                                   device="cpu")) for i in range(n)]
    for _ in range(iters):
        for s in states:
            *s[:], _ = step(*s)
        mean = utils.tree_map(lambda *xs: sum(xs) / n, *[s[0] for s in states])
        for s in states:
            s[0] = mean
    for a, b in zip(utils.tree_leaves(out["params"]),
                    utils.tree_leaves(states[0][0])):
        assert torch.equal(a, b)
    assert len(out["metrics"]) == iters and len(out["metrics"][0]) == n
    assert len(out["iter_s"]) == iters and out["steps_per_s"] > 0
    with pytest.raises(ValueError, match="dispatch must be one of"):
        train_gmis(grid, env, step, T, n * N, 1, dispatch="threads")


def test_init_gmis_draws_each_gmi_from_its_own_seed():
    """``launch.steps.init_gmis``: GMI ``i`` of a 2 x 2 grid holds
    ``init_train(seed + i)`` on a quarter of the envs, leaf for leaf."""
    from repro_torch.envs import make_env
    from repro_torch.launch.steps import init_gmis
    n, N = 4, 6
    env = make_env("BallBalance", megakernel=True, device="cpu")
    grid = tplace.plan_tcg_ex_training(
        2, 2, devices=list(range(n)), devices_per_gpu=2,
        device="cpu").manager.instance_mesh("holistic")
    got = init_gmis(grid, env, n * N, seed=5)
    assert len(got) == n
    for i, st in enumerate(got):
        want = tppo.init_train(5 + i, env, env.spec.policy_dims, N,
                               device="cpu")
        assert st[3].shape[0] == N
        for a, b in zip(utils.tree_leaves(st), utils.tree_leaves(list(want))):
            if isinstance(a, torch.Generator):    # the env's reset draws
                a, b = a.get_state(), b.get_state()
            assert torch.equal(a, b)


def test_run_drl_prints_the_reference_layout_without_jax():
    """The launcher's --workload drl path at 1 x 2 and 2 x 2 GMIs on the
    CPU, in a fresh process that never loads JAX: its GMIManager summary
    and its strategy line equal what the reference's ``run_drl`` prints
    (``repro.comm`` in the reference's line, ``repro_torch.comm`` in the
    port's)."""
    for g, t in ((1, 2), (2, 2)):
        code = ("import sys; from repro_torch.launch.train import main; "
                "main(['--device', 'cpu', '--env', 'BallBalance', "
                f"'--num-gpus', '{g}', '--gmi-per-gpu', '{t}', "
                "'--num-env', '16', '--rollout', '4', '--iters', '1']); "
                "assert 'jax' not in sys.modules, 'jax was imported'; "
                "print('NO_JAX_OK')")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert "NO_JAX_OK" in out.stdout and "done:" in out.stdout
        n_dev = len(jax.devices())
        lay = jplace.plan_tcg_ex_training(
            g, t, devices=list(range(max(n_dev, g * t))),
            devices_per_gpu=t)
        want = lay.manager.summary().splitlines() + [
            "LGR strategy (Algorithm 1 via repro_torch.comm): "
            f"{lay.communicator().strategy}"]
        assert out.stdout.splitlines()[:len(want)] == want


def replay_draw(sensor_seed):
    """Print one sensor draw's readings and, for the params element that
    differs most, every Adam update of it in both packages: the gradient,
    the denominator sqrt(vhat) + EPS and the step it took."""
    with pytest.MonkeyPatch.context() as mp:
        readings, rec = _multi_gmi_run(mp, sensor_seed)
    for it, (grad, diff, slack) in enumerate(readings):
        print(f"iteration {it}: gradient difference {grad:.3g} of its "
              f"leaf's largest; params |port - ref| max "
              f"{max(float(d.max()) for d in diff):.3g}, Adam's slack max "
              f"{max(float(x.max()) for x in slack):.3g}")
    diff = readings[-1][1]
    leaf = max(range(len(diff)), key=lambda i: diff[i].max())
    idx = np.unravel_index(diff[leaf].argmax(), diff[leaf].shape)
    print(f"largest: leaf {leaf} {diff[leaf].shape} at {idx}, "
          f"{float(diff[leaf][idx]):.3g}")
    for u, (j, t) in enumerate(zip(rec["j"], rec["t"])):
        step = j[3]
        (gj, gt), (vj, vt) = [(x[k][leaf][idx], y[k][leaf][idx])
                              for x, y, k in ((j, t, 0), (j, t, 2))]
        mj, mt = j[1][leaf][idx], t[1][leaf][idx]
        dj = np.sqrt(vj / (1 - B2 ** step)) + EPS
        dt = np.sqrt(vt / (1 - B2 ** step)) + EPS
        print(f"update {u:2d} (GMI {u // 4 % 4}, Adam step {step}): g ref "
              f"{gj:+.4g} port {gt:+.4g}; sqrt(vhat)+eps ref {dj:.4g} port "
              f"{dt:.4g}; step ref {LR * mj / (1 - B1 ** step) / dj:+.4g} "
              f"port {LR * mt / (1 - B1 ** step) / dt:+.4g}")


def sweep_draws(lo, hi):
    """One line of readings a sensor draw, for the ``hi - lo`` seeds that
    ``numpy.random.default_rng(lo)`` draws: the largest gradient share,
    params difference and Adam's slack, and the difference over its
    bound, each over both iterations."""
    for seed in np.random.default_rng(lo).integers(0, 2 ** 31, hi - lo):
        with pytest.MonkeyPatch.context() as mp:
            readings, _ = _multi_gmi_run(mp, int(seed))
        grad = max(r[0] for r in readings)
        diff = max(float(d.max()) for r in readings for d in r[1])
        slack = max(float(x.max()) for r in readings for x in r[2])
        ratio = max(float((d / (2e-6 + x)).max()) for r in readings
                    for d, x in zip(r[1], r[2]))
        print(f"seed {int(seed)} gradient share {grad:.3g} params diff "
              f"{diff:.3g} slack {slack:.3g} diff/(2e-6+slack) {ratio:.3g}",
              flush=True)


if __name__ == "__main__":
    # python tests/test_torch_gmi.py SEED: replay one sensor draw;
    # python tests/test_torch_gmi.py --sweep LO HI: readings of many
    if sys.argv[1] == "--sweep":
        sweep_draws(int(sys.argv[2]), int(sys.argv[3]))
    else:
        replay_draw(int(sys.argv[1]))
