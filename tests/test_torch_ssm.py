"""The port's recurrent blocks (``repro_torch/models/ssm.py``: the causal
conv, mLSTM chunkwise and decode, sLSTM, Mamba2 chunked and decode)
against the JAX package's on the CPU, with the reference's
``init_mlstm``/``init_slstm``/``init_mamba2`` weights carried across by
``interop.model_params``.  Inputs come from a numpy seed.

Outputs and states are held to rtol = atol = 1e-5 in f32: the same math
with its sums taken in another order (the port's mLSTM runs
``ops.mlstm_chunkwise``, whose CPU path is the chunk math of
``_mlstm_chunk`` over chunks, where the reference runs it in a
``lax.scan``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch import interop
from repro_torch.models import ssm as TS

TOL = dict(rtol=1e-5, atol=1e-5)
D, H, EXP, W = 64, 2, 2, 4           # di = 128, dh = 64
N = 16                               # Mamba2 state dim: 2 heads of 64


def _close(got, want):
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(want), **TOL)


def _states_close(got, want):
    for f in want._fields:
        _close(getattr(got, f), getattr(want, f))


def _params(init, *args):
    jp = init(jax.random.key(3), *args)
    # non-zero biases and norm scales, so every parameter is exercised
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda x: x + 0.1 * rng.normal(size=x.shape).astype(
        np.float32), jp)
    return jp, interop.model_params(jax.tree.map(np.asarray, jp))


def _mlstm_state(rng, B, zero):
    di, dh = D * EXP, D * EXP // H
    if zero:
        st = JS.mlstm_init_state(B, H, dh, di, W)
    else:
        st = JS.MLSTMState(
            C=rng.normal(size=(B, H, dh, dh)).astype(np.float32),
            n=rng.normal(size=(B, H, dh)).astype(np.float32),
            m=rng.normal(size=(B, H)).astype(np.float32),
            conv=rng.normal(size=(B, W - 1, di)).astype(np.float32))
    return (jax.tree.map(jnp.asarray, st),
            TS.MLSTMState(*[torch.as_tensor(np.array(t)) for t in st]))


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(0)
    jp = JS.init_conv1d(jax.random.key(1), 24, W)
    jp["b"] = jnp.asarray(rng.normal(size=24).astype(np.float32))
    tp = interop.model_params(jax.tree.map(np.asarray, jp))
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    st = rng.normal(size=(2, W - 1, 24)).astype(np.float32)
    for state in (None, st):
        jy, js = JS.causal_conv1d(jp, jnp.asarray(x), None if state is None
                                  else jnp.asarray(state))
        ty, ts = TS.causal_conv1d(tp, torch.as_tensor(x), None if state is None
                                  else torch.as_tensor(state))
        _close(ty, jy)
        _close(ts, js)


@pytest.mark.parametrize("zero", [True, False])
@pytest.mark.parametrize("chunk", [8, 16])
def test_mlstm_apply_matches_reference(zero, chunk):
    """A 32-step block over 4 or 2 chunks, from a zero state and from a
    non-zero (C, n, m, conv): output and every state leaf."""
    rng = np.random.default_rng(5)
    jp, tp = _params(JS.init_mlstm, D, H, EXP, W)
    x = rng.normal(size=(2, 32, D)).astype(np.float32)
    jst, tst = _mlstm_state(rng, 2, zero)
    jy, js = JS.mlstm_apply(jp, jnp.asarray(x), num_heads=H, state=jst,
                            chunk=chunk, expansion=EXP)
    ty, ts = TS.mlstm_apply(tp, torch.as_tensor(x), num_heads=H, state=tst,
                            chunk=chunk, expansion=EXP)
    _close(ty, jy)
    _states_close(ts, js)


def test_mlstm_apply_without_state_and_one_token():
    """``state=None`` starts from the zero state (m = 0), and a one-token
    prompt is one chunk of one step."""
    rng = np.random.default_rng(6)
    jp, tp = _params(JS.init_mlstm, D, H, EXP, W)
    for S in (1, 12):
        x = rng.normal(size=(3, S, D)).astype(np.float32)
        jy, js = JS.mlstm_apply(jp, jnp.asarray(x), num_heads=H, chunk=256,
                                expansion=EXP)
        ty, ts = TS.mlstm_apply(tp, torch.as_tensor(x), num_heads=H,
                                chunk=256, expansion=EXP)
        _close(ty, jy)
        _states_close(ts, js)


def test_mlstm_chunk_must_divide_the_sequence():
    """The reference's quirk, kept: ``mlstm_apply`` raises when
    ``min(chunk, S)`` does not divide S (ROADMAP queue C)."""
    jp, tp = _params(JS.init_mlstm, D, H, EXP, W)
    x = np.zeros((1, 12, D), np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        JS.mlstm_apply(jp, jnp.asarray(x), num_heads=H, chunk=8,
                       expansion=EXP)
    with pytest.raises(ValueError, match="not divisible"):
        TS.mlstm_apply(tp, torch.as_tensor(x), num_heads=H, chunk=8,
                       expansion=EXP)


def test_mlstm_decode_steps_match_reference():
    """Four exact recurrent steps from a non-zero state."""
    rng = np.random.default_rng(7)
    jp, tp = _params(JS.init_mlstm, D, H, EXP, W)
    jst, tst = _mlstm_state(rng, 2, zero=False)
    for _ in range(4):
        x = rng.normal(size=(2, 1, D)).astype(np.float32)
        jy, jst = JS.mlstm_decode_step(jp, jnp.asarray(x), jst, num_heads=H,
                                       expansion=EXP)
        ty, tst = TS.mlstm_decode_step(tp, torch.as_tensor(x), tst,
                                       num_heads=H, expansion=EXP)
        _close(ty, jy)
        _states_close(tst, jst)


def test_mlstm_chunkwise_equals_recurrent_steps():
    """The port's chunkwise block from a state equals its own recurrent
    decode steps over the same tokens (the reference's ssm invariant), to
    1e-4: two algorithms, f32 sums in different orders."""
    rng = np.random.default_rng(8)
    _, tp = _params(JS.init_mlstm, D, H, EXP, W)
    _, tst = _mlstm_state(rng, 1, zero=False)
    x = torch.as_tensor(rng.normal(size=(1, 8, D)).astype(np.float32))
    y, st = TS.mlstm_apply(tp, x, num_heads=H, state=tst, chunk=4,
                           expansion=EXP)
    ys, rs = [], tst
    for t in range(8):
        yt, rs = TS.mlstm_decode_step(tp, x[:, t:t + 1], rs, num_heads=H,
                                      expansion=EXP)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(),
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(rs, st):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("zero", [True, False])
def test_slstm_apply_matches_reference(zero):
    """A 6-step block, then three one-step calls (decode), from a zero
    and from a non-zero state."""
    rng = np.random.default_rng(9)
    jp, tp = _params(JS.init_slstm, D, H)
    dh = D // H
    if zero:
        jst, tst = None, None
    else:
        st = [rng.normal(size=(2, H, dh)).astype(np.float32)
              for _ in range(4)]
        st[1] = np.abs(st[1]) + 0.5          # a normalizer is positive
        jst = JS.SLSTMState(*map(jnp.asarray, st))
        tst = TS.SLSTMState(*map(torch.as_tensor, st))
    for S in (6, 1, 1, 1):
        x = rng.normal(size=(2, S, D)).astype(np.float32)
        jy, jst = JS.slstm_apply(jp, jnp.asarray(x), num_heads=H, state=jst)
        ty, tst = TS.slstm_apply(tp, torch.as_tensor(x), num_heads=H,
                                 state=tst)
        _close(ty, jy)
        _states_close(tst, jst)


def test_init_layouts_match_reference():
    """Same keys and shapes as the reference's ``init_mlstm`` and
    ``init_slstm`` trees; LeCun fan-ins as there (conv over its width,
    ``r`` over dh)."""
    gen = torch.Generator().manual_seed(0)
    for jinit, tinit, args in ((JS.init_mlstm, TS.init_mlstm, (D, H, EXP, W)),
                               (JS.init_slstm, TS.init_slstm, (D, H)),
                               (JS.init_mamba2, TS.init_mamba2, (D, N))):
        theirs = jax.eval_shape(lambda: jinit(jax.random.key(0), *args))
        mine = tinit(gen, *args)
        flat = lambda t: {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                          jax.tree_util.tree_flatten_with_path(t)[0]}
        assert flat(mine) == flat(theirs)
    big = TS.init_slstm(torch.Generator().manual_seed(1), 256, 4)
    assert abs(float(big["r"].std()) - (1 / 64) ** 0.5) < 0.01


# ---------------------------------------------------------------- Mamba2 ----
def _mamba2_state(rng, B, zero):
    di = 2 * D
    if zero:
        st = JS.mamba2_init_state(B, di, N, 64, W)
    else:
        st = JS.Mamba2State(
            h=rng.normal(size=(B, di // 64, 64, N)).astype(np.float32),
            conv=rng.normal(size=(B, W - 1, di + 2 * N)).astype(np.float32))
    return (jax.tree.map(jnp.asarray, st),
            TS.Mamba2State(*[torch.as_tensor(np.array(t)) for t in st]))


def _mamba2_close(ty, ts, jy, js):
    """y and h to 1e-5 (f32 sums in another order); conv, the last W-1
    projected inputs, to the same 1e-5: it holds the input projection's
    output, a GEMM that XLA and PyTorch sum in their own orders."""
    _close(ty, jy)
    _close(ts.h, js.h)
    _close(ts.conv, js.conv)


@pytest.mark.parametrize("zero", [True, False])
@pytest.mark.parametrize("chunk", [8, 32])
def test_mamba2_apply_matches_reference(zero, chunk):
    """A 32-step block over 4 chunks or one, from a zero state and from a
    non-zero (h, conv): output and both state leaves."""
    rng = np.random.default_rng(15)
    jp, tp = _params(JS.init_mamba2, D, N)
    x = rng.normal(size=(2, 32, D)).astype(np.float32)
    jst, tst = _mamba2_state(rng, 2, zero)
    jy, js = JS.mamba2_apply(jp, jnp.asarray(x), state_dim=N, state=jst,
                             chunk=chunk)
    ty, ts = TS.mamba2_apply(tp, torch.as_tensor(x), state_dim=N, state=tst,
                             chunk=chunk)
    _mamba2_close(ty, ts, jy, js)
    # state=None starts from the zero state
    jy, js = JS.mamba2_apply(jp, jnp.asarray(x[:1, :8]), state_dim=N)
    ty, ts = TS.mamba2_apply(tp, torch.as_tensor(x[:1, :8]), state_dim=N)
    _mamba2_close(ty, ts, jy, js)


def test_mamba2_decode_steps_match_reference():
    """Four exact recurrent steps from a non-zero state."""
    rng = np.random.default_rng(16)
    jp, tp = _params(JS.init_mamba2, D, N)
    jst, tst = _mamba2_state(rng, 2, zero=False)
    for _ in range(4):
        x = rng.normal(size=(2, 1, D)).astype(np.float32)
        jy, jst = JS.mamba2_decode_step(jp, jnp.asarray(x), jst, state_dim=N)
        ty, tst = TS.mamba2_decode_step(tp, torch.as_tensor(x), tst,
                                        state_dim=N)
        _mamba2_close(ty, tst, jy, jst)


def test_mamba2_chunkwise_equals_recurrent():
    """The port's chunked scan equals its own recurrent decode steps over
    the same tokens, as ``tests/test_ssm.py`` holds the reference's: y to
    2e-5, h to 2e-4 relative (two algorithms, f32 sums in different
    orders)."""
    rng = np.random.default_rng(17)
    B, S = 2, 16
    _, tp = _params(JS.init_mamba2, D, N)
    x = torch.as_tensor(rng.normal(size=(B, S, D)).astype(np.float32) * 0.5)
    y1, st1 = TS.mamba2_apply(tp, x, state_dim=N, chunk=4)
    st = TS.mamba2_init_state(B, 2 * D, N)
    ys = []
    for t in range(S):
        yt, st = TS.mamba2_decode_step(tp, x[:, t:t + 1], st, state_dim=N)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y1.numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(st.h.numpy(), st1.h.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_array_equal(st.conv.numpy(), st1.conv.numpy())


def test_mamba2_chunk_must_divide_the_sequence():
    """C8 (ROADMAP queue C): ``mamba2_apply`` raises when
    ``min(chunk, S)`` does not divide S, in both packages."""
    jp, tp = _params(JS.init_mamba2, D, N)
    x = np.zeros((1, 12, D), np.float32)
    with pytest.raises(ValueError, match="seq 12 not divisible by chunk 8"):
        JS.mamba2_apply(jp, jnp.asarray(x), state_dim=N, chunk=8)
    with pytest.raises(ValueError, match="seq 12 not divisible by chunk 8"):
        TS.mamba2_apply(tp, torch.as_tensor(x), state_dim=N, chunk=8)
