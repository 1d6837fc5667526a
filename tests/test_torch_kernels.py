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
from repro.models import ssm as jssm
from repro_torch.kernels import (_build, channel_pack, env_megakernel,
                                 flash_attention, fused_policy_mlp, gae_scan,
                                 mlstm_scan, ops, paged_decode, ref)
from repro_torch.models import ssm as tssm

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
    ops.nstep_returns(torch.ones((2, 3)), torch.zeros((2, 3)), torch.ones(3))
    pay = {"obs": torch.ones((2, 3, 4)), "actions": torch.ones((2, 3, 1)),
           "rewards": torch.ones((2, 3)), "dones": torch.zeros((2, 3)),
           "bootstrap": torch.ones(3), "actor_version": 1}
    ops.pack_channels(channel_pack.alloc_rings(pay, 2), pay, 1)
    x = torch.ones((2, 5, 4, 64))
    ops.flash_attention(x, x[:, :, :2], x[:, :, :2])
    pages = torch.ones((3, 4, 2, 64))
    ops.paged_attention(x[:, 0], pages, pages,
                        torch.zeros((3, 4), dtype=torch.int32),
                        torch.ones((2, 2), dtype=torch.int32),
                        torch.tensor([3, -1], dtype=torch.int32))
    ops.mlstm_chunkwise(*_mlstm_args(1, 2, 8, 32, zero=True), chunk=4)
    assert set(ops.LAUNCHES) == {"env_mega_step", "gae_norm", "policy_mlp",
                                 "nstep_returns", "pack_channels",
                                 "paged_attention", "flash_attention",
                                 "mlstm_chunkwise"}
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
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
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.nstep_returns(meta, meta, torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        gae_scan.launch_nstep(c, c, torch.zeros(3), gamma=0.99)
    pay = {"obs": torch.zeros((2, 3, 4)), "actions": torch.zeros((2, 3, 1)),
           "rewards": c, "dones": c, "bootstrap": torch.zeros(3),
           "actor_version": 0}
    rings = channel_pack.alloc_rings(pay, 2)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.pack_channels({"rewards": meta}, pay, 0)
    with pytest.raises(ValueError, match="CUDA"):
        channel_pack.launch(rings, pay, 1)
    with pytest.raises(ValueError, match="outside a ring"):
        channel_pack.launch(rings, pay, 2)
    q = torch.zeros((2, 5, 4, 64))
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.launch(q, q[:, :, :2], q[:, :, :2])
    pages = torch.zeros((3, 4, 2, 64))
    i32 = dict(dtype=torch.int32)
    args = (q[:, 0], pages, pages, torch.zeros((3, 4), **i32),
            torch.zeros((2, 2), **i32), torch.zeros(2, **i32))
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.paged_attention(*[a.to("meta") for a in args])
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode.launch(*args)
    margs = _mlstm_args(1, 2, 8, 32, zero=True)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        ops.mlstm_chunkwise(*[a.to("meta") for a in margs], chunk=4)
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_scan.launch(*margs, chunk=4)
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES


# ---------------------------------------------------------- attention ----
def _paged_case(dtype=np.float32, hd=32):
    """Ragged paged inputs: B = 4 rows over an M = 5 page table of 4-slot
    pages.  Row 0 has an unmapped page in the middle and holes in its
    pages, row 1 maps two pages, row 2 is idle (position -1, nothing
    mapped), row 3 is full.  Mapped virtual page v holds positions
    [4v, 4v + 4) or -1, as the engine writes them; every other page
    (the trash page 0 included) holds random values that must not leak."""
    B, H, KH, P, M, N = 4, 4, 2, 4, 5, 24
    qpos = np.array([17, 6, -1, 19], np.int32)
    table = np.full((B, M), -1, np.int32)
    phys = iter(RNG.permutation(np.arange(1, N)))
    for b, vs in enumerate([(0, 1, 3, 4), (0, 1), (), (0, 1, 2, 3, 4)]):
        for v in vs:
            table[b, v] = next(phys)
    slot_pos = RNG.integers(-1, 40, (N, P)).astype(np.int32)
    slot_pos[0] = -1
    for b in range(B):
        for v in range(M):
            if table[b, v] >= 0:
                p = v * P + np.arange(P)
                p[(p > qpos[b]) | (RNG.uniform(size=P) < 0.2)] = -1
                slot_pos[table[b, v]] = p
    q = RNG.normal(size=(B, H, hd)).astype(dtype)
    kp = RNG.normal(size=(N, P, KH, hd)).astype(dtype)
    vp = RNG.normal(size=(N, P, KH, hd)).astype(dtype)
    return q, kp, vp, slot_pos, table, qpos


@pytest.mark.parametrize("window,cap", [(None, None), (5, None),
                                        (None, 2.0), (9, 3.0)])
def test_paged_attention_plain_matches_pallas_kernel(window, cap):
    """The plain version (the CPU path of ``ops.paged_attention``) against
    the Pallas gather-decode kernel in interpret mode, over ragged pages,
    -1 table entries, empty slots, an idle row, a window and a softcap:
    atol 1e-5 (f32 sums in another order).  The idle row is exactly 0."""
    args = _paged_case()
    want = np.asarray(jops.paged_attention(
        *map(jnp.asarray, args), window=window, softcap=cap,
        interpret=True))
    targs = [torch.as_tensor(a) for a in args]
    for fn in (ref.paged_attention_ref, ops.paged_attention):
        got = fn(*targs, window=window, softcap=cap).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert (got[2] == 0.0).all()
    assert np.isfinite(want).all()


@pytest.mark.parametrize("hd", [80, 112, 160])
def test_paged_attention_plain_matches_pallas_kernel_head_dims(hd):
    """The same ragged paged case at the head dims the reference serves
    beyond 64 and 128 (hubert-xlarge's 80, zamba2-7b's 112, stablelm-12b's
    160), with a window and a softcap: atol 1e-5; the idle row exactly 0."""
    args = _paged_case(hd=hd)
    want = np.asarray(jops.paged_attention(
        *map(jnp.asarray, args), window=9, softcap=3.0, interpret=True))
    got = ops.paged_attention(*[torch.as_tensor(a) for a in args], window=9,
                              softcap=3.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[2] == 0.0).all() and np.isfinite(want).all()


@pytest.mark.parametrize("causal,window,cap", [
    (True, None, None), (True, 7, None), (True, None, 1.5),
    (False, None, None), (False, 10, 2.5)])
def test_flash_attention_plain_matches_pallas_kernel(causal, window, cap):
    """The plain version (the CPU path of ``ops.flash_attention``) against
    the Pallas flash kernel in interpret mode: GQA (4 q heads on 2 kv
    heads), a ragged length (37 over 16-blocks, so padded kv rows), causal
    and bidirectional masks, a window and a softcap: atol 1e-5."""
    B, S, H, KH, hd = 2, 37, 4, 2, 32
    q = RNG.normal(size=(B, S, H, hd)).astype(np.float32)
    k = RNG.normal(size=(B, S, KH, hd)).astype(np.float32)
    v = RNG.normal(size=(B, S, KH, hd)).astype(np.float32)
    want = np.asarray(jops.attention(q, k, v, causal=causal, window=window,
                                     softcap=cap, block_q=16, block_k=16,
                                     interpret=True))
    for fn in (ref.attention_ref, ops.flash_attention):
        got = fn(*map(torch.as_tensor, (q, k, v)), causal=causal,
                 window=window, softcap=cap)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("hd,G,causal", [(80, 1, False), (112, 2, True),
                                         (160, 4, True)])
def test_flash_attention_plain_matches_pallas_kernel_head_dims(hd, G, causal):
    """The flash kernel's plain version against the Pallas kernel in
    interpret mode at hd 80, 112 and 160 (the GQA groups of hubert-xlarge,
    zamba2-7b here at G 2, and stablelm-12b), a ragged length of 37 over
    16-blocks, with a window and a softcap: atol 1e-5."""
    B, S, KH = 1, 37, 2
    q = RNG.normal(size=(B, S, KH * G, hd)).astype(np.float32)
    k = RNG.normal(size=(B, S, KH, hd)).astype(np.float32)
    v = RNG.normal(size=(B, S, KH, hd)).astype(np.float32)
    want = np.asarray(jops.attention(q, k, v, causal=causal, window=11,
                                     softcap=2.5, block_q=16, block_k=16,
                                     interpret=True))
    got = ops.flash_attention(*map(torch.as_tensor, (q, k, v)),
                              causal=causal, window=11, softcap=2.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# -------------------------------------------------------------- mLSTM ----
def _mlstm_args(B, H, S, dh, zero, li_scale=0.5, lf_shift=2.0):
    """q, k, v (B, H, S, dh), log_i, log_f (B, H, S) as the reference's
    kernel test draws them, and a zero or random (C0, n0, m0)."""
    q, k, v = (RNG.normal(size=(B, H, S, dh)).astype(np.float32)
               for _ in range(3))
    li = (RNG.normal(size=(B, H, S)) * li_scale).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        RNG.normal(size=(B, H, S)).astype(np.float32) + lf_shift))
    if zero:
        st = (np.zeros((B, H, dh, dh), np.float32),
              np.zeros((B, H, dh), np.float32), np.zeros((B, H), np.float32))
    else:
        st = (RNG.normal(size=(B, H, dh, dh)).astype(np.float32),
              RNG.normal(size=(B, H, dh)).astype(np.float32),
              RNG.normal(size=(B, H)).astype(np.float32))
    return [torch.as_tensor(np.array(a)) for a in (q, k, v, li, lf, *st)]


def _jax_chunk_scan(args, chunk):
    """The reference's ``_mlstm_chunk`` over chunks from a given state:
    (h, C, n, m)."""
    q, k, v, li, lf, C, n, m = [jnp.asarray(a.numpy()) for a in args]
    S = q.shape[2]
    L = min(chunk, S)
    hs = []
    for c in range(S // L):
        sl = slice(c * L, (c + 1) * L)
        h, C, n, m = jssm._mlstm_chunk(q[:, :, sl], k[:, :, sl],
                                       v[:, :, sl], li[:, :, sl],
                                       lf[:, :, sl], C, n, m)
        hs.append(h)
    return [np.asarray(x) for x in (jnp.concatenate(hs, axis=2), C, n, m)]


@pytest.mark.parametrize("shape", [(1, 2, 128, 16), (2, 4, 256, 32)])
@pytest.mark.parametrize("chunk", [32, 64])
def test_mlstm_plain_matches_pallas_kernel(shape, chunk):
    """The plain version (the CPU path of ``ops.mlstm_chunkwise``) from a
    zero state against the Pallas kernel in interpret mode, at the shapes
    and tolerance of the reference's own kernel test (rtol = atol =
    3e-4)."""
    args = _mlstm_args(*shape, zero=True)
    want = np.asarray(jops.mlstm(*[jnp.asarray(a.numpy()) for a in args[:5]],
                                 chunk=chunk, interpret=True))
    for fn in (ref.mlstm_chunkwise_ref, ops.mlstm_chunkwise):
        h = fn(*args, chunk=chunk)[0]
        np.testing.assert_allclose(h.numpy(), want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("S,chunk", [(48, 16), (1, 16), (40, 64)])
def test_mlstm_plain_from_a_state_matches_reference(S, chunk):
    """From a non-zero (C0, n0, m0), with strongly negative log_f and large
    log_i (the stabiliser matters): h and the final (C, n, m) against the
    reference's ``_mlstm_chunk`` scan (f32, sums in another order).  The
    state to rtol = atol = 1e-5; h, whose values reach ~4, to atol 1e-4:
    gate weights spanning e^+-15 over a 40-step chunk leave a few
    denominators with cancellation (largest error seen 3.7e-5)."""
    args = _mlstm_args(2, 3, S, 16, zero=False, li_scale=5.0, lf_shift=-6.0)
    want = _jax_chunk_scan(args, chunk)
    got = ops.mlstm_chunkwise(*args, chunk=chunk)
    for g, w, atol in zip(got, want, (1e-4, 1e-5, 1e-5, 1e-5)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=atol)
    assert all(np.isfinite(w).all() for w in want)


def test_mlstm_plain_without_the_inter_chunk_term_fails(monkeypatch):
    """Mutation check: a plain version whose chunks ignore the carried C
    when reading (the inter-chunk term dropped) misses the reference by
    far more than the tolerance, so the parity tests above can see it."""
    args = _mlstm_args(2, 3, 48, 16, zero=False)
    want = _jax_chunk_scan(args, 16)
    good = tssm._mlstm_chunk

    def no_inter(q, k, v, li, lf, C, n, m):
        h = good(q, k, v, li, lf, torch.zeros_like(C), n, m)[0]
        return (h, *good(q, k, v, li, lf, C, n, m)[1:])
    monkeypatch.setattr(tssm, "_mlstm_chunk", no_inter)
    h = ref.mlstm_chunkwise_ref(*args, chunk=16)[0].numpy()
    assert np.abs(h - want[0]).max() > 1e-2
