"""Parity of the port's async A3C with the JAX package on the CPU: the
n-step returns, the loss and one trainer update, whole ``AsyncRunner``
rounds on both branches of ``round`` (direct produce into the ring, and
staged collect + ring pack, blocking and double-buffered), plus the
launcher in a process that never loads JAX.

Params, Adam state and env state are carried from the reference runner;
each actor's action noise is replayed from its JAX key (per step
``key, akey = split(key)`` then ``normal(akey, mu.shape)``).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import make_env as jax_make_env
from repro.kernels import ops as jops
from repro.models.policy import init_policy as jax_init_policy
from repro.optim import adam_init as jax_adam_init
from repro.rl import a3c as ja3c
from repro_torch import interop, utils
from repro_torch.kernels import ops, ref
from repro_torch.rl import a3c as ta3c

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RNG = np.random.default_rng(11)
DIMS = (60, 32, 16, 8)        # Ant obs/act with a narrow trunk


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Every test draws the same inputs whatever ran before it on its
    worker."""
    global RNG
    RNG = np.random.default_rng(11)


def _np(x):
    return jax.tree.map(np.array, x)


def _replay_noise(key, T, N, act):
    draws = []
    for _ in range(T):
        key, akey = jax.random.split(key)
        draws.append(np.array(jax.random.normal(akey, (N, act))))
    return torch.as_tensor(np.stack(draws))


def _scan_inputs(T, N):
    r = RNG.normal(size=(T, N)).astype(np.float32)
    d = (RNG.uniform(size=(T, N)) < 0.2).astype(np.float32)
    boot = RNG.normal(size=(N,)).astype(np.float32)
    return r, d, boot


@pytest.mark.parametrize("T,N", [(8, 5), (16, 33)])
def test_nstep_returns_plain_matches_pallas_kernel(T, N):
    """The plain scan (``ref``, ``ops`` on the CPU, and ``a3c.nstep_returns``
    fused or not) against the Pallas kernel (interpret): atol 1e-6, float32
    scans of the same order."""
    r, d, boot = _scan_inputs(T, N)
    want = np.asarray(jops.nstep_returns(r, d, boot, interpret=True))
    targs = [torch.as_tensor(x) for x in (r, d, boot)]
    for got in (ref.nstep_returns_ref(*targs), ops.nstep_returns(*targs),
                ta3c.nstep_returns(*targs, use_fused_kernels=True),
                ta3c.nstep_returns(*targs)):
        assert got.shape == (T, N) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # the column views a partial ring snapshot hands out
    wide = [torch.as_tensor(np.concatenate([x, x], axis=-1)) for x in
            (r, d)]
    got = ta3c.nstep_returns(wide[0][:, N:], wide[1][:, N:], targs[2],
                             use_fused_kernels=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _experience(T, N):
    """A small collected Experience from the reference (Ant, narrow
    trunk), with two envs forced to reset inside it."""
    env = jax_make_env("Ant")
    params = jax_init_policy(jax.random.key(4), DIMS)
    es, obs = env.reset(jax.random.PRNGKey(5), num_envs=N)
    es = es._replace(t=es.t.at[jnp.array([0, 3])].set(
        env.spec.max_episode_len - 2))
    exp, _, _, _ = ja3c.actor_collect(params, jnp.int32(2), env, es, obs,
                                      jax.random.PRNGKey(6), T)
    return params, exp


@pytest.mark.parametrize("fused", [False, True])
def test_a3c_loss_and_trainer_update_match_reference(fused):
    """Loss and its three parts to 1e-5; params and Adam moments after one
    update (Adam beta2 0.999, global-norm clip 1.0) to atol 1e-6."""
    T, N = 6, 8
    params, exp = _experience(T, N)
    assert float(exp.dones.sum()) >= 2
    texp = interop.experience(_np(exp))
    tparams = interop.policy_params(_np(params))
    jl, jaux = ja3c.a3c_loss(params, exp, 0.99, 0.5, 0.01, fused)
    tl, taux = ta3c.a3c_loss(tparams, texp, 0.99, 0.5, 0.01, fused)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    for g, w in zip(taux, jaux):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-5)
    opt = jax_adam_init(params)
    jp, jo, jloss = ja3c.trainer_update(params, opt, exp,
                                        use_fused_kernels=fused)
    tp, to, tloss = ta3c.trainer_update(tparams, interop.adam_state(_np(opt)),
                                        texp, use_fused_kernels=fused)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert int(to.step) == int(jo.step) == 1
    moved = max(float((g - w).abs().max()) for g, w in zip(
        utils.tree_leaves(tp), utils.tree_leaves(tparams)))
    assert moved > 1e-4
    for g, w in zip(utils.tree_leaves(tp), jax.tree.leaves(_np(jp))):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6)
    for g, w in zip(utils.tree_leaves(to.nu), jax.tree.leaves(_np(jo.nu))):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-10)
    assert int(ta3c.staleness(5, texp)) == 3


def _runner_pair(megakernel, overlap, N=8, T=4):
    jenv = jax_make_env("Ant", megakernel=megakernel)
    tenv = interop.env_like("Ant", jenv.mega, megakernel=megakernel)
    kw = dict(num_envs=N, num_steps=T, seed=3, overlap=overlap,
              use_fused_kernels=True)
    jr = ja3c.AsyncRunner(jenv, [0, 1], [2], **kw)
    tr = ta3c.AsyncRunner(tenv, [0, 1], [2], device="cpu", **kw)
    tr.params = interop.policy_params(_np(jr.params))
    tr.opt_state = interop.adam_state(_np(jr.opt_state))
    tr.actor_params = tr.params
    for a, (es, obs, _) in jr.actors.items():
        tr.actors[a] = [interop.env_state(_np(es)),
                        torch.as_tensor(np.array(obs)), tr.actors[a][2]]
    return jr, tr


@pytest.mark.parametrize("megakernel,overlap", [(True, False),
                                                (False, False),
                                                (False, True)])
def test_async_runner_rounds_match_reference(megakernel, overlap):
    """Two rounds and the closing drain of the reference runner and the
    port's, from carried params, Adam state and env states with each
    actor's noise replayed: losses to 1e-4, staleness lists, sample counts
    and transfer stats equal, params to 1e-5.  ``megakernel`` without
    overlap is the direct-produce branch (``collect_ring`` into the ring
    slot); the others push staged Experiences through ``pack_channels``."""
    T, N = 4, 8
    jr, tr = _runner_pair(megakernel, overlap, N, T)
    for _ in range(2):
        noise = {a: _replay_noise(jr.actors[a][2], T, N, 8)
                 for a in jr.serving_gmis}
        jl, js = jr.round()
        tl, ts = tr.round(noise)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        assert ts == js
    jl, js = jr.finish()
    tl, ts = tr.finish()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert ts == js
    assert tr.predictions == jr.predictions == 2 * 2 * T * N
    assert tr.trained_samples == jr.trained_samples == tr.predictions
    assert tr.version == int(jr.version) == 2
    for k in ("num_transfers", "total_bytes", "ops"):
        assert getattr(tr.pipe.stats, k) == getattr(jr.pipe.stats, k), k
    assert tr.pipe.delivered_samples == jr.pipe.delivered_samples
    for g, w in zip(utils.tree_leaves(tr.params),
                    jax.tree.leaves(_np(jr.params))):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


def test_async_runner_defaults_to_cuda():
    """Without a card the default device raises rather than running on the
    CPU; an env on another device than the runner's is refused."""
    tenv = interop.env_like("Ant", jax_make_env("Ant").mega)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ta3c.AsyncRunner(tenv, [0], [1], num_envs=4, num_steps=2)
    with pytest.raises(ValueError, match="env lives on"):
        ta3c.AsyncRunner(tenv, [0], [1], num_envs=4, num_steps=2,
                         device="meta")


def test_async_launcher_runs_without_jax():
    """``launch/async_a3c.py`` on both branches, two rounds each on the
    CPU, in a fresh process that never loads JAX; every pushed sample is
    trained on."""
    code = (
        "import sys; from repro_torch.launch.async_a3c import main\n"
        "for extra in (['--megakernel'], ['--overlap', '--trainer-gmis', "
        "'2']):\n"
        "    r = main(['--device', 'cpu', '--env', 'BallBalance', "
        "'--num-env', '8', '--rollout', '4', '--rounds', '2'] + extra)\n"
        "    assert r.trained_samples == r.predictions == 2 * 2 * 4 * 8\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NO_JAX_OK')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "NO_JAX_OK" in out.stdout
    assert out.stdout.count("delivered == predicted: True") == 2
