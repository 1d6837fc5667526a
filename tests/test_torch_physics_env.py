"""Parity of the PyTorch port's physics and envs (``repro_torch.envs``)
with the JAX package, on the CPU.

Inputs are made with numpy (or by the reference, then carried across with
``repro_torch.interop``) and pass through both packages.  Integer outputs
(hashes, ``t``, ``done``, ``resets``, ``seed``) must match exactly; each
float comparison states its tolerance and why.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import make_env as jax_make_env
from repro.envs import physics as jphys
from repro_torch import interop
from repro_torch.envs import all_env_names, make_env
from repro_torch.envs import physics as tphys

RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Every test draws the same inputs whatever ran before it on its
    worker."""
    global RNG
    RNG = np.random.default_rng(0)


def _tree_np(x):
    return jax.tree.map(np.array, x)


def test_hash_u32_bit_exact():
    x = np.concatenate([
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32),
        RNG.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
        .astype(np.uint32)])
    want = np.asarray(jphys.hash_u32(jnp.asarray(x)))
    got = tphys.hash_u32(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_counter_normal_matches_reference():
    """The hash words and 24-bit uniforms are integer-exact; the normals
    go through log/sqrt/cos, whose XLA and libm versions differ by a few
    ulps, so they match to atol 1e-6 (values are O(1))."""
    seed = RNG.integers(0, 2 ** 31 - 1, size=(64, 1)).astype(np.int32)
    counter = RNG.integers(0, 1000, size=(64, 1)).astype(np.int32)
    idx = np.arange(21, dtype=np.uint32)[None, :]
    want = np.asarray(jphys.counter_normal(seed, counter, idx))
    got = tphys.counter_normal(torch.as_tensor(seed),
                               torch.as_tensor(counter),
                               torch.as_tensor(idx.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("J", [3, 21])
def test_substeps_match_reference(J):
    """Four chain substeps from a random state.  atol 1e-5: float32
    sin/cos/cumsum agree to ulps and four substeps compound them."""
    jp = jphys.default_params(J)
    tp = tphys.ChainParams(torch.as_tensor(np.array(jp.masses)),
                           torch.as_tensor(np.array(jp.lengths)),
                           *jp[2:])
    n = 16
    q = RNG.uniform(-1, 1, (n, J)).astype(np.float32)
    qd = RNG.uniform(-3, 3, (n, J)).astype(np.float32)
    root = RNG.uniform(-0.5, 0.8, (n, 6)).astype(np.float32)
    tau = RNG.uniform(-1, 1, (n, J)).astype(np.float32)
    want = jax.vmap(lambda a, b, c, d: jphys.rollout_substeps(
        a, b, c, d, jp, 1 / 60, 4))(q, qd, root, tau)
    got = tphys.rollout_substeps(*map(torch.as_tensor, (q, qd, root, tau)),
                                 tp, 1 / 60, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    tip_w = jax.vmap(lambda a, z: jphys.tip_height(a, z, jp))(q, root[:, 2])
    tip_g = tphys.tip_height(torch.as_tensor(q),
                             torch.as_tensor(root[:, 2]), tp)
    np.testing.assert_allclose(tip_g.numpy(), np.asarray(tip_w), atol=1e-5)


def test_default_params_match_reference():
    """Link masses and lengths from cos/sin: ulp-level, atol 1e-6."""
    jp, tp = jphys.default_params(21), tphys.default_params(21)
    np.testing.assert_allclose(tp.masses.numpy(), np.asarray(jp.masses),
                               atol=1e-6)
    np.testing.assert_allclose(tp.lengths.numpy(), np.asarray(jp.lengths),
                               atol=1e-6)
    assert tuple(tp[2:]) == tuple(jp[2:])


@pytest.mark.parametrize("name", all_env_names())
@pytest.mark.parametrize("megakernel", [False, True])
def test_env_steps_match_reference(name, megakernel):
    """Three steps of every Table-6 env on both step paths from a state
    carried from the reference, with two envs forced to reset on the
    first step.  Bookkeeping is exact; obs to atol 2e-5 and reward to
    2e-4, the reference's own tolerances between its two step paths."""
    jenv = jax_make_env(name, megakernel=megakernel)
    tenv = interop.env_like(name, jenv.mega, megakernel)
    n, J = 8, jenv.spec.act_dim
    js, jo = jenv.reset(jax.random.PRNGKey(3), num_envs=n)
    js = js._replace(t=js.t.at[jnp.array([1, 6])].set(
        jenv.spec.max_episode_len - 1))
    ts = interop.env_state(_tree_np(js))
    np.testing.assert_allclose(
        tenv._obs_fn(ts).numpy(), np.asarray(jo), atol=2e-5)
    jstep = jax.jit(jenv.step)
    for k in range(3):
        a = RNG.uniform(-1.5, 1.5, (n, J)).astype(np.float32)
        js, jo, jr, jd = jstep(js, jnp.asarray(a))
        ts, to, tr, td = tenv.step(ts, torch.as_tensor(a))
        assert td.dtype == torch.bool
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd) != 0)
        if k == 0:
            assert td[1] and td[6]
        for f in ("t", "seed", "resets"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f)
        for f in ("q", "qd", "root", "prev_action"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       atol=2e-5, err_msg=f)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-4)


def test_reset_matches_reference_from_carried_seeds():
    """Per-env seeds come from jax.random in the reference, so they are
    carried across; the fresh state is then a pure function of
    (seed, resets).  q0 = 0.1 * counter_normal: atol 1e-7."""
    jenv = jax_make_env("Humanoid")
    tenv = interop.env_like("Humanoid", jenv.mega)
    js, jo = jenv.reset(jax.random.PRNGKey(5), num_envs=6)
    seeds = torch.as_tensor(np.array(js.seed))
    ts = tenv._reset_fn(seeds, torch.full_like(seeds, 4))
    jfresh = jax.jit(jax.vmap(jenv._reset_fn))(js.seed, js.resets + 4)
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(jfresh.q), atol=1e-7)
    np.testing.assert_array_equal(ts.resets.numpy(),
                                  np.asarray(jfresh.resets))
    np.testing.assert_array_equal(ts.root.numpy(), np.asarray(jfresh.root))


def test_reset_from_generator_is_seeded():
    env = make_env("Ant", device="cpu")
    s1, o1 = env.reset(torch.Generator().manual_seed(0), 5)
    s2, o2 = env.reset(torch.Generator().manual_seed(0), 5)
    assert s1.seed.dtype == torch.int32 and s1.t.dtype == torch.int32
    assert torch.equal(s1.seed, s2.seed) and torch.equal(o1, o2)
    assert o1.shape == (5, 60)


def test_make_env_defaults_to_cuda():
    """Entry points run on the card unless the caller asks for the CPU:
    without a card the default raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert make_env("Ant").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_env("Ant")
    assert make_env("Ant", device="cpu").device.type == "cpu"
