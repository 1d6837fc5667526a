"""The port's kernels on the CPU: each plain version in
``repro_torch.kernels.ref`` (what ``ops`` runs for CPU tensors) against the
JAX package's Pallas kernel in interpret mode, plus the guards that keep a
CPU call off the CUDA build and a non-CPU tensor off the plain path.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these same plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import make_env as jax_make_env
from repro.kernels import ops as jops
from repro.kernels.env_megakernel import mega_step_ring
from repro_torch import interop
from repro_torch.envs import SPECS
from repro_torch.kernels import (_build, env_megakernel, fused_policy_mlp,
                                 gae_scan, ops, ref)

RNG = np.random.default_rng(1)


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Every test draws the same inputs whatever ran before it on its
    worker."""
    global RNG
    RNG = np.random.default_rng(1)


def _ring_np(T, S, N, spec, fill):
    return {"obs": np.full((T, S * N, spec.obs_dim), fill, np.float32),
            "actions": np.full((T, S * N, spec.act_dim), fill, np.float32),
            "rewards": np.full((T, S * N), fill, np.float32),
            "dones": np.full((T, S * N), fill, np.float32)}


def _env_case(name, N, forced):
    jenv = jax_make_env(name, megakernel=True)
    state, obs = jenv.reset(jax.random.PRNGKey(2), num_envs=N)
    state = state._replace(t=state.t.at[jnp.asarray(forced)].set(
        jenv.spec.max_episode_len - 1))
    a = RNG.uniform(-1.5, 1.5, (N, jenv.spec.act_dim)).astype(np.float32)
    mc = jenv.mega
    kw = dict(chain=mc.chain, task=mc.task, substeps=jenv.spec.substeps,
              dt=jenv.spec.dt, max_episode_len=jenv.spec.max_episode_len)
    tstate = interop.env_state(jax.tree.map(np.array, state))
    tmc = interop.mega_consts(mc)
    targs = (*tstate, torch.as_tensor(a), torch.as_tensor(np.array(obs)))
    tconsts = (tmc.sensor, tmc.tgt, tmc.masses, tmc.lengths)
    return jenv, state, obs, a, mc, kw, targs, tconsts


_OUT = ("q", "qd", "root", "prev_action", "t", "seed", "resets", "obs",
        "reward", "done")


def _assert_step_equal(got, want, ctx):
    """Integer outputs and done exact; floats to atol 2e-5, the
    reference's own tolerance between its kernel and its oracle."""
    for nm, g, w in zip(_OUT, got[:10], want[:10]):
        g = interop.to_numpy(g)
        if nm in ("t", "seed", "resets", "done"):
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=f"{ctx} {nm}")
        else:
            np.testing.assert_allclose(g, np.asarray(w), atol=2e-5,
                                       err_msg=f"{ctx} {nm}")


@pytest.mark.parametrize("name", ["Ant", "Humanoid"])
def test_env_mega_step_plain_matches_pallas_kernel(name):
    """The Pallas megakernel (interpret, ring mode, slot 1 of 2, sentinel
    fill) against both plain versions: all ten step outputs, the four
    ring-slot writes, and sentinel survival outside the written row."""
    N, T, S, slot, step_t = 8, 4, 2, 1, 2
    jenv, js, jo, a, mc, kw, targs, tconsts = _env_case(name, N, [3, 5])
    jout = jops.env_mega_step(*js, jnp.asarray(a), jo,
                              jax.tree.map(jnp.asarray,
                                           _ring_np(T, S, N, jenv.spec, -7.0)),
                              step_t, slot, mc.sensor, mc.tgt, mc.masses,
                              mc.lengths, block_envs=4, interpret=True, **kw)
    for plain in (ref.env_mega_step_ref, ref.mega_step, ops.env_mega_step):
        bufs = {k: torch.as_tensor(v) for k, v in
                _ring_np(T, S, N, jenv.spec, -7.0).items()}
        tout = plain(*targs, bufs, step_t, slot, *tconsts, **kw)
        _assert_step_equal(tout, jout, plain.__name__)
        assert tout[10] is bufs          # ring written in place
        for c in ("obs", "actions", "rewards", "dones"):
            got = bufs[c].numpy()
            np.testing.assert_allclose(got, np.asarray(jout[10][c]),
                                       atol=2e-5, err_msg=c)
            keep = np.ones(got.shape[:2], bool)
            keep[step_t, slot * N:(slot + 1) * N] = False
            assert (got[keep] == -7.0).all(), c


@pytest.mark.parametrize("name", list(SPECS))
def test_mega_step_matches_reference_all_envs(name):
    """The fused plain step (the CPU path of ``ops.env_mega_step``)
    against the reference's fused XLA program for every Table-6 env, with
    a forced reset and one ring row (T=1)."""
    N = 6
    jenv, js, jo, a, mc, kw, targs, tconsts = _env_case(name, N, [0, 4])
    jout = mega_step_ring(*js, jnp.asarray(a), jo,
                          jax.tree.map(jnp.asarray,
                                       _ring_np(1, 1, N, jenv.spec, 0.0)),
                          0, 0, mc.sensor, mc.tgt, mc.masses, mc.lengths,
                          **kw)
    bufs = {k: torch.as_tensor(v)
            for k, v in _ring_np(1, 1, N, jenv.spec, 0.0).items()}
    tout = ops.env_mega_step(*targs, bufs, 0, 0, *tconsts, **kw)
    _assert_step_equal(tout, jout, name)
    assert (tout[9][[0, 4]] == 1.0).all()
    for c in bufs:
        np.testing.assert_allclose(bufs[c].numpy(), np.asarray(jout[10][c]),
                                   atol=2e-5)
    # no ring: same step, nothing written
    nout = ops.env_mega_step(*targs, None, 0, 0, *tconsts, **kw)
    _assert_step_equal(nout, jout, name + " no ring")
    assert nout[10] is None


@pytest.mark.parametrize("T,N", [(8, 5), (16, 33)])
def test_gae_norm_plain_matches_pallas_kernel(T, N):
    """Reverse scan + population-std normalisation over all T*N: atol
    1e-5 (the float32 mean/variance sums are ordered differently)."""
    r = RNG.normal(size=(T, N)).astype(np.float32)
    v = RNG.normal(size=(T, N)).astype(np.float32)
    d = (RNG.uniform(size=(T, N)) < 0.2).astype(np.float32)
    last = RNG.normal(size=(N,)).astype(np.float32)
    wa, wr = jops.gae_norm(r, v, d, last, interpret=True)
    for fn in (ref.gae_norm_ref, ops.gae_norm):
        ga, gr = fn(*map(torch.as_tensor, (r, v, d, last)))
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), atol=1e-5)
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=1e-5)
    # population std: the normalised advantages have unit variance
    assert abs(float(ga.std(correction=0)) - 1.0) < 1e-4


@pytest.mark.parametrize("name", list(SPECS))
def test_policy_mlp_plain_matches_pallas_kernel(name):
    """Every Table-6 trunk width (ragged Humanoid included) at N = 40:
    atol 1e-5 (float32 dot products summed in another order)."""
    dims = SPECS[name].policy_dims[:-1]
    x = RNG.uniform(-1, 1, (40, dims[0])).astype(np.float32)
    ws = [(RNG.normal(size=(a, b)) * (2 / a) ** 0.5).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(RNG.normal(size=(b,)) * 0.1).astype(np.float32) for b in dims[1:]]
    want = np.asarray(jops.policy_mlp(x, ws, bs, interpret=True))
    got = ops.policy_mlp(torch.as_tensor(x), [torch.as_tensor(w) for w in ws],
                         [torch.as_tensor(b) for b in bs])
    assert got.shape == (40, dims[-1])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_cpu_calls_never_build_and_count_nothing(monkeypatch):
    """A CPU tensor takes the plain version: no nvcc, no library load, and
    every launch counter stays 0."""
    def refuse(*a, **k):
        raise AssertionError("CPU path reached the CUDA build")
    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    ops.reset_launches()
    x = torch.ones((3, 4))
    ops.policy_mlp(x, [torch.ones((4, 5))], [torch.zeros(5)])
    ops.gae_norm(torch.ones((2, 3)), torch.ones((2, 3)), torch.zeros((2, 3)),
                 torch.ones(3))
    env = interop.env_like("Ant", jax_make_env("Ant").mega, megakernel=True)
    s, o = env.reset(torch.Generator().manual_seed(0), 4)
    env.step(s, torch.zeros((4, 8)))
    assert ops.LAUNCHES == {"env_mega_step": 0, "gae_norm": 0,
                            "policy_mlp": 0}
    assert _build._libs == {}


def test_non_cpu_tensors_never_fall_back(monkeypatch):
    """A tensor off the CPU goes to the kernel or raises: an unsupported
    device is refused by ``ops``, and each binding refuses a non-CUDA
    tensor before it loads the library."""
    def refuse(*a, **k):
        raise AssertionError("validation must come before the build")
    monkeypatch.setattr(_build, "load", refuse)
    meta = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.gae_norm(meta, meta, meta, torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.policy_mlp(meta, [torch.empty((3, 4), device="meta")],
                       [torch.empty(4, device="meta")])
    c = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        gae_scan.launch(c, c, c, torch.zeros(3), gamma=0.99, lam=0.95,
                        eps=1e-8)
    with pytest.raises(ValueError, match="CUDA"):
        fused_policy_mlp.launch(c, [torch.zeros((3, 4))], [torch.zeros(4)])
    with pytest.raises(ValueError, match="exceed"):
        fused_policy_mlp.launch(torch.zeros((2, 513)),
                                [torch.zeros((513, 4))], [torch.zeros(4)])
    mc = interop.mega_consts(jax_make_env("Ant").mega)
    q = torch.zeros((4, 8))
    i = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        env_megakernel.launch(q, q, torch.zeros((4, 6)), q, i, i, i, q, None,
                              None, 0, 0, mc.sensor, mc.tgt, mc.masses,
                              mc.lengths, chain=mc.chain, task=mc.task,
                              substeps=4, dt=1 / 60, max_episode_len=1000)
    assert ops.LAUNCHES == {"env_mega_step": 0, "gae_norm": 0,
                            "policy_mlp": 0}
