"""LM training in the port (``models/transformer.py::loss_fn``,
``_chunked_xent``, ``remat``; ``launch/steps.py::make_train_step``;
``optim/adam.py``'s SGD and cosine schedule; ``launch/train.py --workload
lm``) against the JAX package on the CPU.  Params come from the
reference's ``init_model`` through ``interop.model_params``; batches from
``make_batch`` (numpy, the same in both packages).  Loss to 1e-5, every
gradient leaf within 1e-4 of that leaf's largest magnitude (f32 GEMMs
summed in other orders through two layers and their backward)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.checkpoint import load as jload
from repro.checkpoint import load_manifest as jload_manifest
from repro.configs import get_reduced as jget_reduced
from repro.configs.base import InputShape as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch import interop, optim as TO
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.configs.base import InputShape, TrainConfig
from repro_torch.data import make_batch
from repro_torch.kernels import ops
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.utils import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
SHAPE = InputShape("t", 32, 2, "train")


def _setup(arch, seed=3):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp = JT.init_model(jax.random.key(seed), jcfg)
    tp = interop.model_params(jax.tree.map(np.asarray, jp))
    batch = make_batch(cfg, SHAPE, seed=seed)
    return jcfg, cfg, jp, tp, batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _value_and_grad(cfg, tp, batch, remat=True):
    flat, spec = torch.utils._pytree.tree_flatten(tp)
    xs = [x.clone().requires_grad_() for x in flat]
    loss = TT.loss_fn(torch.utils._pytree.tree_unflatten(xs, spec), cfg,
                      _torch_batch(batch), remat=remat)
    grads = torch.autograd.grad(loss, xs, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), torch.utils._pytree.tree_unflatten(list(grads), spec)


def _held(tgrads, jgrads, tol=GRAD_TOL):
    """The worst leaf's max |diff| over its largest |reference|; every
    leaf the reference moves must move here too."""
    worst = 0.0
    jl = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tl = dict((jax.tree_util.keystr(k), v) for k, v in
              jax.tree_util.tree_flatten_with_path(
                  interop.to_numpy(tgrads))[0])
    assert len(jl) == len(tl)
    for k, jv in jl:
        jv, tv = np.asarray(jv), tl[jax.tree_util.keystr(k)]
        scale = float(np.abs(jv).max())
        err = float(np.abs(tv - jv).max())
        rel = err / scale if scale > 0 else err
        assert rel <= tol, (jax.tree_util.keystr(k), err, scale)
        worst = max(worst, rel)
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """``loss_fn`` and its gradient at every arch's reduced config (every
    branch: causal LM, audio masked prediction, text-only VLM loss; MoE
    aux), against ``jax.value_and_grad`` of the reference, one compile an
    arch."""
    jcfg, cfg, jp, tp, batch = _setup(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b)))(jp, jb)
    tl, tg = _value_and_grad(cfg, tp, batch)
    assert abs(tl - float(jl)) <= LOSS_TOL, (tl, float(jl))
    _held(tg, jg)


def test_remat_equals_no_remat():
    """Recomputing each layer (and each xent chunk) in the backward gives
    the same loss and gradients, bit for bit, at a dense and a patterned
    stack."""
    for arch in ("internlm2-1.8b", "zamba2-7b"):
        _, cfg, _, tp, batch = _setup(arch)
        l1, g1 = _value_and_grad(cfg, tp, batch, remat=True)
        l0, g0 = _value_and_grad(cfg, tp, batch, remat=False)
        assert l1 == l0
        for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("S,chunk", [(37, 16), (40, 512)])
def test_chunked_xent_matches_reference(S, chunk):
    """An S that is not a multiple of the chunk (padding masked) and one
    chunk; loss and the gradient of h."""
    rng = np.random.default_rng(S)
    jcfg, cfg = jget_reduced("internlm2-1.8b"), get_reduced("internlm2-1.8b")
    jp = JT.init_model(jax.random.key(1), jcfg)
    tp = interop.model_params(jax.tree.map(np.asarray, jp))
    h = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    mask = (rng.random((2, S)) < 0.7).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda x: JT._chunked_xent(
        x, jcfg, jp, jnp.asarray(labels), jnp.asarray(mask), chunk))(
            jnp.asarray(h))
    th = torch.as_tensor(h).requires_grad_()
    tl = TT._chunked_xent(th, cfg, tp, torch.as_tensor(labels),
                          torch.as_tensor(mask), chunk)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg),
                               atol=GRAD_TOL * float(np.abs(jg).max()))


def _adam_slack(tc, to, jo, step=1):
    """Per leaf, how far one Adam step can carry the params apart given
    the gradient difference it was fed (read back from ``mu``): the
    update ``lr * mhat / (sqrt(vhat) + eps)`` changes by at most ``lr *
    (1 + |mhat| / den) / den`` per unit of gradient, den = sqrt(vhat) +
    eps; where |g| is a few eps that is ~1e4 times the gradient's float
    noise (ROADMAP C10)."""
    b1c, b2c = 1 - tc.beta1 ** step, 1 - tc.beta2 ** step
    out = []
    for mt, mj, vt, vj in zip(tree_leaves(interop.to_numpy(to.mu)),
                              jax.tree.leaves(jo.mu),
                              tree_leaves(interop.to_numpy(to.nu)),
                              jax.tree.leaves(jo.nu)):
        mj, vj = np.asarray(mj, np.float64), np.asarray(vj, np.float64)
        den = np.sqrt(np.minimum(vt, vj) / b2c) + 1e-8
        mhat = np.maximum(np.abs(mt), np.abs(mj)) / b1c
        dg = np.abs(mt - mj) / (1 - tc.beta1)
        out.append(tc.learning_rate * (1 + mhat / den) / den * dg)
    return out


@pytest.mark.parametrize("micro", [1, 2])
def test_make_train_step_matches_reference(micro):
    """Two steps of the LM train step (remat, gradient accumulation over
    ``micro`` splits, Adam with clipping and weight decay; granite's MoE
    aux included) against the reference's builder on a 1 x 1 mesh: both
    losses to 1e-5 (the second reads the first update's params); after
    the first step the moments within 1e-4 (``mu``, the clipped gradient)
    and 2e-4 (``nu``) of each leaf's largest, and the params within 1e-6
    plus Adam's response to that gradient difference."""
    arch = "granite-moe-1b-a400m"
    jcfg, cfg, jp, tp, _ = _setup(arch)
    jtc = JTrain(microbatches=micro, weight_decay=0.01, learning_rate=1e-3)
    tc = TrainConfig(microbatches=micro, weight_decay=0.01,
                     learning_rate=1e-3)
    shape = InputShape("t", 16, 4, "train")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    tfn, (psds, osds, bsds) = TS.make_train_step(
        cfg, make_mesh((1, 1), ("data", "model")), shape, tc)
    assert {k: tuple(v.shape) for k, v in bsds.items()} == \
        {"tokens": (4, 16), "labels": (4, 16)}
    assert all(s == (None,) * len(s) for s in tree_leaves(
        tfn.specs["params"], is_leaf=lambda x: isinstance(x, tuple)))
    jo, to = JO.adam_init(jp), TO.adam_init(tp)
    from repro.models.moe import set_moe_sharding
    try:
        with mesh:
            jfn, _ = JS.make_train_step(jcfg, mesh,
                                        JShape("t", 16, 4, "train"), jtc)
            for i in range(2):
                b = make_batch(cfg, shape, seed=10 + i)
                jp, jo, jm = jfn(jp, jo, {k: jnp.asarray(v)
                                          for k, v in b.items()})
                tp, to, tm = tfn(tp, to, _torch_batch(b))
                assert abs(float(tm["loss"]) - float(jm["loss"])) \
                    <= LOSS_TOL, (i, float(tm["loss"]), float(jm["loss"]))
                if i == 0:
                    _held(to.mu, jo.mu, GRAD_TOL)
                    _held(to.nu, jo.nu, 2 * GRAD_TOL)
                    slack = _adam_slack(tc, to, jo)
                    for x, y, sl in zip(tree_leaves(interop.to_numpy(tp)),
                                        jax.tree.leaves(jp), slack):
                        assert np.all(np.abs(x - np.asarray(y))
                                      <= 1e-6 + sl)
    finally:
        # the reference's builder sets module-level sharding hooks
        JT.set_activation_sharding(None)
        set_moe_sharding(None)
    assert int(to.step) == int(jo.step) == 2


def test_train_step_refuses_an_uneven_microbatch_split():
    """A batch of 3 does not split into 2 microbatches: the step raises
    (the reference's reshape to (M, B // M) raises too) rather than train
    on part of the batch."""
    cfg = get_reduced("internlm2-1.8b")
    shape = InputShape("t", 8, 3, "train")
    tfn, _ = TS.make_train_step(cfg, None, shape,
                                TrainConfig(microbatches=2))
    tp = TT.init_model(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        tfn(tp, TO.adam_init(tp), _torch_batch(make_batch(cfg, shape,
                                                          seed=0)))


def test_sgd_and_cosine_warmup_match_reference():
    """20 steps of momentum SGD under the cosine warmup schedule, from the
    same params and gradients: the schedule to 1e-7, params and momentum
    to 1e-6."""
    rng = np.random.default_rng(4)
    p = {"a": rng.normal(size=(5, 3)).astype(np.float32),
         "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    jsched = JO.cosine_warmup(0.1, 4, 15)
    tsched = TO.cosine_warmup(0.1, 4, 15)
    jp, tp = jax.tree.map(jnp.asarray, p), interop.model_params(p)
    js = JO.sgd_init(jp)
    ts = interop.sgd_state(jax.tree.map(np.asarray, js))
    assert int(ts.step) == 0 and ts.step.dtype == torch.int32
    for i in range(20):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), p)
        step = np.int32(i + 1)
        assert abs(float(tsched(torch.tensor(step))) -
                   float(jsched(jnp.asarray(step)))) <= 1e-7
        jp, js = JO.sgd_update(jax.tree.map(jnp.asarray, g), js, jp,
                               lr=jsched, momentum=0.8)
        tp, ts = TO.sgd_update(interop.model_params(g), ts, tp, lr=tsched,
                               momentum=0.8)
    assert int(ts.step) == int(js.step) == 20
    for a, b in ((tp, jp), (ts.mom, js.mom)):
        for x, y in zip(tree_leaves(interop.to_numpy(a)),
                        jax.tree.leaves(b)):
            np.testing.assert_allclose(x, np.asarray(y), atol=1e-6)


def test_kernel_functions_differentiate_their_plain_versions(monkeypatch):
    """The autograd Functions around the card's two training kernels, with
    the launches stood in for by their plain versions on CPU tensors:
    each launch counts once, and every input's gradient (q, k, v; the
    mLSTM's q, k, v, gates and initial state) equals autograd of the
    plain version to 1e-6, with the reference's chunked route above the
    threshold."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan, ref
    monkeypatch.setattr(fa, "launch", lambda *a, **k: ref.attention_ref(
        *a, **k))
    monkeypatch.setattr(mlstm_scan, "launch", lambda *a, chunk: (
        ref.mlstm_chunkwise_ref(*a, chunk)))
    g = torch.Generator().manual_seed(0)

    def leaves(*shapes):
        return [torch.randn(s, generator=g) for s in shapes]

    ops.reset_launches()
    for S, thr, kw in ((24, 4096, dict(causal=True, window=9)),
                       (24, 8, dict(causal=False, softcap=3.0))):
        q, k, v = leaves((2, S, 4, 16), (2, S, 2, 16), (2, S, 2, 16))
        w = torch.randn((2, S, 4, 16), generator=g)
        want = [x.clone().requires_grad_() for x in (q, k, v)]
        torch.autograd.backward(
            (ref.attention_ref(*want, **kw) * w).sum())
        got = [x.clone().requires_grad_() for x in (q, k, v)]
        route, pos = TA._route(S, S, thr), torch.arange(S)[None]
        out = ops._FlashAttention.apply(
            *got, kw.get("causal"), kw.get("window"), kw.get("softcap"),
            None, lambda *x: route(*x, pos, pos, kw.get("causal"),
                                   kw.get("window"), kw.get("softcap"),
                                   16 ** -0.5))
        (out * w).sum().backward()
        for a, b in zip(got, want):
            torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=0)
    B, H, S, dh = 2, 3, 16, 8
    args = leaves((B, H, S, dh), (B, H, S, dh), (B, H, S, dh), (B, H, S),
                  (B, H, S), (B, H, dh, dh), (B, H, dh), (B, H))
    args[4] = torch.nn.functional.logsigmoid(args[4] + 2)
    w = torch.randn((B, H, S, dh), generator=g)
    wc = torch.randn((B, H, dh, dh), generator=g)
    want = [x.clone().requires_grad_() for x in args]
    h, C, _, _ = ref.mlstm_chunkwise_ref(*want, 4)
    ((h * w).sum() + (C * wc).sum()).backward()
    got = [x.clone().requires_grad_() for x in args]
    h, C, _, _ = ops._MLSTMChunkwise.apply(*got, 4)
    ((h * w).sum() + (C * wc).sum()).backward()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=0)
    assert ops.LAUNCHES["flash_attention"] == 2
    assert ops.LAUNCHES["mlstm_chunkwise"] == 1
    ops.reset_launches()


def test_train_lm_without_jax_and_checkpoint_loads_in_reference(tmp_path):
    """``launch/train.py --workload lm --device cpu`` in a process where
    importing JAX fails (and with no ``--device``, it refuses to run
    without a card); its ``--ckpt`` loads in the reference's
    ``checkpoint.load`` into the reference's tree, equal to what the port
    returned."""
    ck = str(tmp_path / "lm")
    code = (
        "import sys, numpy as np; sys.modules['jax'] = None\n"
        "from repro_torch.launch import train\n"
        "try:\n"
        "    train.main(['--workload', 'lm', '--steps', '1'])\n"
        "    raise SystemExit('ran on the CPU by default')\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "out = train.main(['--workload', 'lm', '--arch', 'xlstm-1.3b', "
        "'--device', 'cpu', '--steps', '3', '--batch', '2', '--seq', '32', "
        f"'--ckpt', {ck!r}])\n"
        "assert len(out['losses']) == 3 and all(np.isfinite(out['losses']))\n"
        "from repro_torch import interop\n"
        "from repro_torch.checkpoint.ckpt import keystr_leaves\n"
        "np.savez(" + repr(ck + "_want.npz") + ", **{k: v for k, v in "
        "keystr_leaves(interop.to_numpy({'params': out['params']}))})\n"
        "assert sys.modules['jax'] is None\n"
        "print('NO_JAX_OK')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    assert "NO_JAX_OK" in out.stdout and "checkpoint saved" in out.stdout
    jcfg = jget_reduced("xlstm-1.3b")
    jp = JT.init_model(jax.random.key(0), jcfg)
    like = {"params": jp, "opt": JO.adam_init(jp)}
    tree = jload(ck, like)
    assert jload_manifest(ck)["step"] == 3 and int(tree["opt"].step) == 3
    want = np.load(ck + "_want.npz")
    got = jax.tree_util.tree_flatten_with_path({"params": tree["params"]})[0]
    assert sorted(want.files) == sorted(jax.tree_util.keystr(k)
                                        for k, _ in got)
    for k, v in got:
        np.testing.assert_array_equal(np.asarray(v),
                                      want[jax.tree_util.keystr(k)])
