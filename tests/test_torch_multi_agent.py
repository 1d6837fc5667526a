"""The port's multi-agent env family (``repro_torch/envs/multi_agent.py``)
and its launcher against the JAX package on the CPU.

Both packages build the K-agent Ant in one process, so they draw the same
sensor matrix (ROADMAP queue C, C5); each test asserts that first.  World
seeds come from each package's own generator, so the port's are carried
into the reference's reset, and reference states are carried into the
port with ``interop.env_state``.  Exact: ``t``, ``seed``, ``resets``,
``done`` and the shared done of a world's agents.  Floats: the env state,
obs and reward to 1e-6 (f32, the same ops in the same order); a
trajectory's obs, values and log-probs to 2e-5 and rewards to 2e-4, the
tolerances of ``tests/test_torch_ppo.py``'s ``collect`` test, whose
policy matmuls round in another order."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import make_multi_agent_env as jmake
from repro.envs import suite as jsuite
from repro.models.policy import init_policy as jinit_policy
from repro.rl import rollout as jroll
from repro_torch import interop
from repro_torch.envs import SPECS, make_multi_agent_env
from repro_torch.rl import rollout as troll

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def _np(x):
    return jax.tree.map(np.array, x)


def _envs(K):
    jenv, tenv = jmake("Ant", K), make_multi_agent_env("Ant", K,
                                                       device="cpu")
    J = SPECS["Ant"].act_dim
    want = jsuite._sensor_matrix("Ant", 6 + 4 * J + 3, SPECS["Ant"].obs_dim)
    np.testing.assert_array_equal(tenv.sensor.numpy(), np.asarray(want))
    return jenv, tenv


def _same_state(ts, js, tol=TOL):
    for f in ("t", "seed", "resets"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("q", "qd", "root", "prev_action"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=tol, err_msg=f)


@pytest.mark.parametrize("K", [1, 2, 4])
def test_reset_and_steps_match_reference(K):
    """Reset 4 worlds from the port's seeds, then four steps with world 1
    at its episode cap and world 2's root below Ant's fall height, so both
    reset on the first step: bookkeeping and done exact, every agent of a
    world done together, floats to 1e-6."""
    jenv, tenv = _envs(K)
    W, J = 4, tenv.spec.act_dim
    n = W * K
    ts, to = tenv.reset(torch.Generator().manual_seed(5), n)
    assert ts.q.shape == (W, K * J) and to.shape == (n, tenv.spec.obs_dim)
    seeds = jnp.asarray(ts.seed.numpy())
    js = jenv._reset(seeds, jnp.zeros((W,), jnp.int32))
    _same_state(ts, js)
    np.testing.assert_allclose(to.numpy(), np.asarray(jenv._obs(js))
                               .reshape(n, -1), rtol=0, atol=TOL)
    js = js._replace(t=js.t.at[1].set(tenv.spec.max_episode_len - 1),
                     root=js.root.at[2, 2].set(0.01))
    ts = interop.env_state(_np(js))
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(K)
    for k in range(4):
        a = rng.uniform(-1.5, 1.5, (n, J)).astype(np.float32)
        js, jo, jr, jd = jstep(js, jnp.asarray(a))
        ts, to, tr, td = tenv.step(ts, torch.as_tensor(a))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        if k == 0:
            assert td.reshape(W, K)[1:3].all() and not td.reshape(W, K)[0].any()
            assert ts.resets.tolist() == [0, 1, 1, 0]
        assert (td.reshape(W, K) == td.reshape(W, K)[:, :1]).all()
        _same_state(ts, js)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=TOL)


def test_collect_matches_reference_and_shares_done():
    """``collect`` of 6 steps over 4-agent Ant worlds (3 worlds, one at its
    episode cap), with the reference's action noise replayed into the
    port: the trajectory, the final state, and each world's agents done
    together."""
    jenv, tenv = _envs(4)
    W, K, T = 3, 4, 6
    n = W * K
    dims = tenv.spec.policy_dims
    jparams = jinit_policy(jax.random.key(2), dims)
    ts, _ = tenv.reset(torch.Generator().manual_seed(9), n)
    js = jenv._reset(jnp.asarray(ts.seed.numpy()), jnp.zeros((W,), jnp.int32))
    js = js._replace(t=js.t.at[0].set(tenv.spec.max_episode_len - 2))
    jobs = jenv._obs(js).reshape(n, -1)
    key = jax.random.PRNGKey(4)
    jtraj, jes, jlast_obs, jlast, _ = jroll.collect(jparams, jenv, js, jobs,
                                                    key, T)
    noise = []
    for _ in range(T):
        key, akey = jax.random.split(key)
        noise.append(np.array(jax.random.normal(akey, (n, dims[-1]))))
    ttraj, tes, tlast_obs, tlast = troll.collect(
        interop.policy_params(_np(jparams)), tenv, interop.env_state(_np(js)),
        torch.as_tensor(np.array(jobs)), None, T,
        noise=torch.as_tensor(np.stack(noise)))
    for f in ("obs", "actions", "log_probs", "values"):
        np.testing.assert_allclose(getattr(ttraj, f).numpy(),
                                   np.asarray(getattr(jtraj, f)), atol=2e-5,
                                   err_msg=f)
    np.testing.assert_allclose(ttraj.rewards.numpy(),
                               np.asarray(jtraj.rewards), atol=2e-4)
    np.testing.assert_array_equal(ttraj.dones.numpy(),
                                  np.asarray(jtraj.dones))
    d = ttraj.dones.reshape(T, W, K)
    assert (d == d[:, :, :1]).all() and d[1, 0].all()
    _same_state(tes, jes, 2e-5)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=2e-5)


def test_errors_match_reference():
    """``num_envs`` not a multiple of K and ``with_megakernel(True)`` raise
    the reference's errors; ``with_megakernel(False)`` is the env itself."""
    jenv, tenv = _envs(4)
    msgs = []
    for env, gen in ((jenv, jax.random.PRNGKey(0)),
                     (tenv, torch.Generator().manual_seed(0))):
        with pytest.raises(ValueError) as e:
            env.reset(gen, 6)
        msgs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            env.with_megakernel(True)
        msgs.append(str(e.value))
        assert env.with_megakernel(False) is env
    assert msgs[:2] == msgs[2:]
    assert "multiple of num_agents=4" in msgs[0]
    assert "vmap-only" in msgs[1]


def test_launcher_runs_without_jax_and_defaults_to_the_card():
    """``launch/multi_agent_rollout.py`` in a process where importing JAX
    fails: without a card it refuses to run by default; on the CPU when
    asked it collects 8 steps of 32 agents and the single-agent Ant."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch\n"
        "from repro_torch.launch import multi_agent_rollout as m\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        m.main([])\n"
        "        raise SystemExit('ran on the CPU by default')\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "traj, t1 = m.main(['--device', 'cpu'])\n"
        "assert tuple(traj.obs.shape) == (8, 32, 60)\n"
        "assert tuple(t1.obs.shape) == (8, 8, 60)\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print('NO_JAX_OK')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    assert "NO_JAX_OK" in out.stdout and "4-agent Ant" in out.stdout
