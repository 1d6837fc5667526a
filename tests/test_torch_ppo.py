"""Parity of the port's rollout and PPO with the JAX package on the CPU,
plus the guards on the port as a whole: it imports no JAX, it runs a tiny
iteration end to end without JAX in the process, and its entry points
default to the card.

JAX's random streams cannot be reproduced in torch, so each test replays
the reference's key schedule (per collect step ``key, akey = split(key)``
then ``normal(akey, mu.shape)``; per epoch ``key, pkey = split(key)`` then
``permutation(pkey, T*N)``) and hands the draws to the port.
"""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import make_env as jax_make_env
from repro.rl import ppo as jppo
from repro.rl import rollout as jroll
from repro_torch import interop, utils
from repro_torch.models.policy import policy_apply, policy_apply_fused
from repro_torch.rl import ppo as tppo
from repro_torch.rl import rollout as troll

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RNG = np.random.default_rng(3)


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Every test draws the same inputs whatever ran before it on its
    worker."""
    global RNG
    RNG = np.random.default_rng(3)
DIMS = (60, 32, 16, 8)        # Ant obs/act with a narrow trunk


def _np(x):
    return jax.tree.map(np.array, x)


def _replay_noise(key, T, N, act):
    draws = []
    for _ in range(T):
        key, akey = jax.random.split(key)
        draws.append(np.array(jax.random.normal(akey, (N, act))))
    return np.stack(draws), key


def _replay_perms(key, epochs, n):
    perms = []
    for _ in range(epochs):
        key, pkey = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(pkey, n)))
    return np.stack(perms)


def _setup(megakernel, N, key=0):
    jenv = jax_make_env("Ant", megakernel=megakernel)
    tenv = interop.env_like("Ant", jenv.mega, megakernel)
    params, opt, es, obs = jppo.init_train(jax.random.key(key), jenv, DIMS,
                                           num_envs=N)
    # two envs hit their episode limit on the first step
    es = es._replace(t=es.t.at[jnp.array([2, 5])].set(
        jenv.spec.max_episode_len - 1))
    return jenv, tenv, params, opt, es, obs


def _assert_env_state(ts, js, atol):
    for f in ("t", "seed", "resets"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("q", "qd", "root", "prev_action"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), atol=atol,
                                   err_msg=f)


@pytest.mark.parametrize("fused", [False, True])
def test_collect_matches_reference(fused):
    """Six acting steps of 8 envs (megakernel env and fused trunk when
    ``fused``).  Trajectory floats to atol 2e-5 (obs, values, log-probs
    carry float32 matmul-order noise), rewards to 2e-4 (the reference's
    own env tolerance), dones and env bookkeeping exact."""
    T, N = 6, 8
    jenv, tenv, params, _, es, obs = _setup(fused, N)
    key = jax.random.PRNGKey(4)
    jtraj, jes, jobs, jlast, _ = jroll.collect(params, jenv, es, obs, key, T)
    noise, _ = _replay_noise(key, T, N, 8)
    ttraj, tes, tobs, tlast = troll.collect(
        interop.policy_params(_np(params)), tenv, interop.env_state(_np(es)),
        torch.as_tensor(np.array(obs)), None, T,
        policy_apply_fused if fused else policy_apply,
        noise=torch.as_tensor(noise))
    for f in ("obs", "actions", "log_probs", "values"):
        np.testing.assert_allclose(getattr(ttraj, f).numpy(),
                                   np.asarray(getattr(jtraj, f)), atol=2e-5,
                                   err_msg=f)
    np.testing.assert_allclose(ttraj.rewards.numpy(),
                               np.asarray(jtraj.rewards), atol=2e-4)
    np.testing.assert_array_equal(ttraj.dones.numpy(),
                                  np.asarray(jtraj.dones))
    assert ttraj.dones[0, 2] == 1 and ttraj.dones[0, 5] == 1
    _assert_env_state(tes, jes, 2e-5)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=2e-5)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=2e-5)


def test_gae_and_gae_fused_match_reference():
    """Plain GAE (no normalisation) and fused GAE (normalised over the
    whole batch): atol 1e-5, float32 sums in another order."""
    T, N = 12, 5
    r, v = RNG.normal(size=(2, T, N)).astype(np.float32)
    d = (RNG.uniform(size=(T, N)) < 0.2).astype(np.float32)
    last = RNG.normal(size=(N,)).astype(np.float32)
    targs = [torch.as_tensor(x) for x in (r, v, d, last)]
    for jfn, tfn in ((jroll.gae, troll.gae), (jroll.gae_fused,
                                               troll.gae_fused)):
        wa, wr = jfn(*map(jnp.asarray, (r, v, d, last)), 0.99, 0.95)
        ga, gr = tfn(*targs, 0.99, 0.95)
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), atol=1e-5)
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_train_iteration_matches_reference(fused):
    """One full PPO iteration from params, Adam state and env state carried
    from the reference, with its noise and permutations replayed: fused
    (megakernel env, fused trunk and GAE, batch-global normalisation,
    single-gather minibatches) and unfused (vmap env, per-minibatch
    normalisation).  Bookkeeping exact; metrics to 1e-5; obs and env floats
    to 2e-5.  Params after 4 Adam steps to atol 1e-6, not to the float32
    ulp: Adam divides by sqrt(vhat), which amplifies the float noise of a
    small gradient element (one near zero can take a full +-lr = 3e-4
    step whichever way the noise tips its sign), so params are held looser
    than the gradients (test_ppo_loss_and_grads_match_reference)."""
    T, N = 6, 8
    jcfg = jppo.PPOConfig(num_steps=T, num_epochs=2, num_minibatches=2,
                          use_fused_kernels=fused)
    tcfg = tppo.PPOConfig(**jcfg._asdict())
    jenv, tenv, params, opt, es, obs = _setup(fused, N, key=1)
    key = jax.random.PRNGKey(7)
    tp = interop.policy_params(_np(params))
    topt = interop.adam_state(_np(opt))
    tes = interop.env_state(_np(es))
    tobs = torch.as_tensor(np.array(obs))
    jp, jo, jes, jobs, _, jm = jppo.train_iteration(
        params, opt, jenv, es, obs, key, jcfg)
    noise, key_after = _replay_noise(key, T, N, 8)
    perms = _replay_perms(key_after, jcfg.num_epochs, T * N)
    tp, topt, tes, tobs, _, tm = tppo.train_iteration(
        tp, topt, tenv, tes, tobs, None, tcfg,
        noise=torch.as_tensor(noise), perms=torch.as_tensor(perms))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert float(tm["episode_done_frac"]) > 0     # the forced resets ran
    _assert_env_state(tes, jes, 2e-5)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=2e-5)
    assert int(topt.step) == int(jo.step) == 4
    for g, w in zip(utils.tree_leaves(tp), jax.tree.leaves(_np(jp))):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6)


def test_init_train_defaults_to_cuda():
    """Without a card the default device raises rather than running on
    the CPU; on the CPU when asked, it returns the reference's 4-tuple
    plus the generator the draws came from."""
    tenv = interop.env_like("Ant", jax_make_env("Ant").mega)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tppo.init_train(0, tenv, DIMS, 4)
    p, o, es, obs, gen = tppo.init_train(0, tenv, DIMS, 4, device="cpu")
    assert obs.shape == (4, 60) and int(o.step) == 0
    assert isinstance(gen, torch.Generator)
    mu, _, v = policy_apply(p, obs)
    assert mu.shape == (4, 8) and v.shape == (4,)


def test_make_train_step_improves_reward_on_ballbalance():
    """The port learns: the reference's own convergence check
    (tests/test_rl.py), on the fused path on the CPU."""
    from repro_torch.envs import make_env
    env = make_env("BallBalance", megakernel=True, device="cpu")
    cfg = tppo.PPOConfig(num_steps=16, num_epochs=2, num_minibatches=2,
                         lr=1e-3, use_fused_kernels=True)
    state = list(tppo.init_train(0, env, env.spec.policy_dims, 128,
                                 device="cpu"))
    step = tppo.make_train_step(env, cfg)
    rewards = []
    for _ in range(25):
        *state, m = step(*state)
        rewards.append(float(m["reward_mean"]))
    assert all(np.isfinite(rewards))
    assert np.mean(rewards[-5:]) > np.mean(rewards[:5]), rewards


def _port_files():
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py",
                                             "kernel_times.py",
                                             "gmi_probe.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_repro():
    """No module of the port, nor chip_smoke.py, kernel_times.py or
    gmi_probe.py, imports ``jax`` (or ``jaxlib``) or the JAX package
    ``repro``."""
    bad = []
    files = _port_files()
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [(path, m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_tiny_cpu_iteration_runs_without_jax():
    """The launcher's --workload drl path, two instances with parameter
    averaging, one iteration on the CPU, in a fresh process that never
    loads JAX."""
    code = ("import sys; from repro_torch.launch.train import main; "
            "main(['--device', 'cpu', '--env', 'BallBalance', '--num-gpus',"
            " '1', '--gmi-per-gpu', '2', '--num-env', '16', '--rollout',"
            " '4', '--iters', '1']); "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "print('NO_JAX_OK')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "NO_JAX_OK" in out.stdout and "done:" in out.stdout
