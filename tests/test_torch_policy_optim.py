"""Parity of the port's utils, Adam and Table-6 policy with the JAX package
on the CPU.  Params and inputs are made with numpy or by the reference and
carried across with ``repro_torch.interop``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.models import policy as jpol
from repro.optim import adam as jadam
from repro.rl.ppo import PPOConfig as JPPOConfig
from repro.rl.ppo import ppo_loss as jppo_loss
from repro_torch import interop, utils
from repro_torch.envs import SPECS
from repro_torch.models import policy as tpol
from repro_torch.optim import adam as tadam
from repro_torch.rl.ppo import PPOConfig, loss_and_grads

RNG = np.random.default_rng(2)


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Every test draws the same inputs whatever ran before it on its
    worker."""
    global RNG
    RNG = np.random.default_rng(2)


def _params_np(dims, key=0):
    return jax.tree.map(np.array, jpol.init_policy(jax.random.key(key), dims))


def test_global_norm_and_he_init():
    tree = {"a": RNG.normal(size=(3, 4)).astype(np.float32),
            "b": [RNG.normal(size=(5,)).astype(np.float32)]}
    np.testing.assert_allclose(
        float(utils.global_norm(interop.policy_params(tree))),
        float(jutils.global_norm(tree)), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    w = utils.he_init(g, (4000, 50))
    assert w.shape == (4000, 50) and w.dtype == torch.float32
    assert abs(float(w.std()) - (2 / 4000) ** 0.5) < 1e-3


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
@pytest.mark.parametrize("beta2", [0.95, 0.999])
def test_adam_update_matches_reference(grad_clip, beta2):
    """Three Adam steps with and without global-norm clipping (grads of
    norm ~10, so the clip bites).  rtol 1e-5: the update divides by
    sqrt(vhat) + eps in float32 on both sides."""
    params = _params_np((12, 16, 8, 3))
    jp, jst = params, jadam.adam_init(params)
    tp = interop.policy_params(params)
    tst = tadam.adam_init(tp)
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: (RNG.normal(size=x.shape) * 2).astype(np.float32),
            params)
        jp, jst = jadam.adam_update(grads, jst, jp, lr=1e-2, beta2=beta2,
                                    grad_clip=grad_clip)
        tp, tst = tadam.adam_update(interop.policy_params(grads), tst, tp,
                                    lr=1e-2, beta2=beta2,
                                    grad_clip=grad_clip)
    assert int(tst.step) == int(jst.step) == 3
    for got, want in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
        for g, w in zip(utils.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-7)


def test_adam_clip_uses_reference_formula():
    """scale = min(1, clip / max(gn, 1e-12)): clipped grads have norm
    exactly ``clip``; the first Adam step is then lr * sign(g)."""
    p = {"w": torch.zeros(4)}
    g = {"w": torch.tensor([3.0, -4.0, 0.0, 0.0])}
    newp, st = tadam.adam_update(g, tadam.adam_init(p), p, lr=0.1,
                                 grad_clip=1.0)
    np.testing.assert_allclose(st.mu["w"].numpy(),
                               [0.1 * 0.6, -0.1 * 0.8, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(newp["w"].numpy(), [-0.1, 0.1, 0, 0],
                               rtol=1e-5)


@pytest.mark.parametrize("name", list(SPECS))
def test_policy_apply_matches_reference(name):
    """Every Table-6 policy at its published widths, 16 observations:
    mu/value to atol 1e-5 (float32 matmuls summed in another order);
    ``policy_apply_fused`` on CPU tensors equals ``policy_apply``."""
    dims = SPECS[name].policy_dims
    params = _params_np(dims)
    obs = RNG.uniform(-1, 1, (16, dims[0])).astype(np.float32)
    want = jpol.policy_apply(params, obs)
    tp = interop.policy_params(params)
    got = tpol.policy_apply(tp, torch.as_tensor(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    fused = tpol.policy_apply_fused(tp, torch.as_tensor(obs))
    for g, f in zip(got, fused):
        assert torch.equal(g, f)


def test_init_policy_layout():
    g = torch.Generator().manual_seed(0)
    p = tpol.init_policy(g, (24, 256, 128, 64, 3))
    jp = _params_np((24, 256, 128, 64, 3))
    got = jax.tree.map(lambda x: x.shape, interop.to_numpy(p))
    assert got == jax.tree.map(lambda x: x.shape, jp)


def test_sample_log_prob_entropy_match_reference():
    """Sampled action to atol 1e-6 (numpy's and torch's float32 exp differ
    by an ulp); log-density and entropy to atol 1e-5 (log(2*pi) is folded
    in float32 by JAX and in double by the port, an ulp apart)."""
    mu = RNG.normal(size=(7, 5)).astype(np.float32)
    ls = (RNG.normal(size=(7, 5)) * 0.3).astype(np.float32)
    noise = RNG.normal(size=(7, 5)).astype(np.float32)
    a = tpol.sample_action(*map(torch.as_tensor, (mu, ls, noise)))
    np.testing.assert_allclose(a.numpy(), mu + np.exp(ls) * noise, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        tpol.log_prob(*map(torch.as_tensor, (mu, ls)), a).numpy(),
        np.asarray(jpol.log_prob(mu, ls, a.numpy())), atol=1e-5)
    np.testing.assert_allclose(tpol.entropy(torch.as_tensor(ls)).numpy(),
                               np.asarray(jpol.entropy(ls)), atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_ppo_loss_and_grads_match_reference(fused):
    """The clipped-surrogate loss and its gradient on one minibatch, with
    per-minibatch advantage normalisation (population std) on the unfused
    path and none on the fused one.  Loss to rtol 1e-5, gradients to atol
    1e-5: autograd and jax.grad sum the same products in another order."""
    dims = (24, 32, 16, 3)
    params = _params_np(dims, key=3)
    B = 48
    batch = (RNG.uniform(-1, 1, (B, 24)).astype(np.float32),
             RNG.normal(size=(B, 3)).astype(np.float32),
             RNG.normal(size=(B,)).astype(np.float32) - 3.0,
             RNG.normal(size=(B,)).astype(np.float32) * 2.0 + 0.5,
             RNG.normal(size=(B,)).astype(np.float32))
    jcfg = JPPOConfig(use_fused_kernels=fused)
    (jl, _), jg = jax.value_and_grad(jppo_loss, has_aux=True)(
        params, jax.tree.map(jnp.asarray, batch), jcfg.clip_eps,
        jcfg.vf_coef, jcfg.ent_coef, jpol.policy_apply, not fused)
    tl, tg = loss_and_grads(interop.policy_params(params),
                            [torch.as_tensor(x) for x in batch],
                            PPOConfig(use_fused_kernels=fused))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for g, w in zip(utils.tree_leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
