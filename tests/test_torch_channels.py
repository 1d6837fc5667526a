"""The port's MCC experience pipeline on the CPU: the ring pack and
``collect_ring`` against the JAX package, the delivered stream of whole
pipelines against the reference's, and the ring and pipeline invariants
of ``tests/test_channels.py`` and ``tests/test_env_megakernel.py`` on the
port's own classes.

Ring contents are copies, so ring comparisons are exact.  JAX's random
streams cannot be reproduced in torch, so ``collect_ring`` replays the
reference's key schedule (per step ``key, akey = split(key)`` then
``normal(akey, mu.shape)``) and hands the draws to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channels as jch
from repro.envs import make_env as jax_make_env
from repro.kernels import channel_pack as jcp
from repro.kernels import ops as jops
from repro.models.policy import init_policy as jax_init_policy
from repro.rl import a3c as ja3c
from repro.rl import rollout as jroll
from repro_torch import interop
from repro_torch.core.channels import (CHANNELS, Batcher, ChannelRing,
                                       Compressor, HostStagedPipeline,
                                       Migrator, MultiChannelPipeline,
                                       TransferStats, UniChannelPipeline)
from repro_torch.kernels import channel_pack, ops, ref
from repro_torch.rl import rollout as troll
from repro_torch.rl.a3c import Experience, actor_collect

RNG = np.random.default_rng(5)


@pytest.fixture(autouse=True)
def _fresh_rng():
    """Every test draws the same inputs whatever ran before it on its
    worker."""
    global RNG
    RNG = np.random.default_rng(5)


def _exp(T=4, N=6, obs=5, act=2, version=1, base=0.0):
    return Experience(
        obs=torch.full((T, N, obs), base + 1.0),
        actions=torch.full((T, N, act), base + 2.0),
        rewards=torch.arange(T * N, dtype=torch.float32).reshape(T, N) + base,
        dones=torch.zeros((T, N)),
        bootstrap=torch.full((N,), base + 3.0),
        actor_version=version)


def _random_payload(T, N, obs, act, version):
    return {"obs": RNG.normal(size=(T, N, obs)).astype(np.float32),
            "actions": RNG.normal(size=(T, N, act)).astype(np.float32),
            "rewards": RNG.normal(size=(T, N)).astype(np.float32),
            "dones": (RNG.uniform(size=(T, N)) < 0.2).astype(np.float32),
            "bootstrap": RNG.normal(size=(N,)).astype(np.float32),
            "actor_version": np.int32(version)}


def _bases_of(batches, N=6):
    """Per-push base ids from delivered batches, in delivery order (push
    base b writes rewards[0, 0] == b in its column block)."""
    out = []
    for b in batches:
        r = b.rewards
        for j in range(r.shape[1] // N):
            out.append(float(r[0, j * N]))
    return out


def _deliver(out):
    return [b for _, bs in sorted(out.items()) for b in bs]


# ------------------------------------------------------------ ring pack ---
def test_pack_channels_plain_matches_pallas_kernel():
    """Five pushes into a 3-slot ring (the wrap overwrites slots 0 and 1)
    through the Pallas kernel (interpret) and through the port's plain
    pack, written in place: every channel exact after every push, and
    untouched slots keep their sentinel."""
    T, N, S, obs, act = 3, 5, 3, 7, 2
    sentinel = {c: np.full(s, -9, np.int32 if c == "actor_version"
                           else np.float32)
                for c, s in (("obs", (T, S * N, obs)),
                             ("actions", (T, S * N, act)),
                             ("rewards", (T, S * N)), ("dones", (T, S * N)),
                             ("bootstrap", (S, N)),
                             ("actor_version", (S, 1)))}
    jbufs = {c: jnp.asarray(v) for c, v in sentinel.items()}
    tbufs = interop.rings(sentinel)
    for i in range(5):
        pay = _random_payload(T, N, obs, act, 10 + i)
        slot = i % S
        jbufs = jops.pack_channels(jbufs, {c: jnp.asarray(v)
                                           for c, v in pay.items()},
                                   slot, interpret=True)
        tpay = {c: torch.as_tensor(v) for c, v in pay.items()}
        if i % 2:
            tpay["actor_version"] = int(pay["actor_version"])
        out = ops.pack_channels(tbufs, tpay, slot)
        assert out is tbufs                     # written in place
        for c in CHANNELS:
            np.testing.assert_array_equal(tbufs[c].numpy(),
                                          np.asarray(jbufs[c]), err_msg=c)
        if i < S - 1:                           # later slots still unwritten
            assert (tbufs["rewards"][:, (i + 1) * N:] == -9).all()
            assert (tbufs["actor_version"][i + 1:] == -9).all()
    assert tbufs["actor_version"].dtype == torch.int32


def test_alloc_rings_and_pack_generation_match_reference():
    """Zero rings of the reference's shapes and types, and the overlap
    ring's bulk pack of three staged pushes, exact."""
    pays = [_random_payload(2, 4, 3, 2, v) for v in (3, 4, 5)]
    jr = jcp.alloc_rings({c: jnp.asarray(v) for c, v in pays[0].items()}, 3)
    tr = channel_pack.alloc_rings(
        {c: torch.as_tensor(v) for c, v in pays[0].items()}, 3)
    for c in CHANNELS:
        np.testing.assert_array_equal(tr[c].numpy(), np.asarray(jr[c]))
        assert str(tr[c].dtype).split(".")[-1] == str(jr[c].dtype)
    jg = jcp.pack_generation([{c: jnp.asarray(v) for c, v in p.items()}
                              for p in pays])
    tg = channel_pack.pack_generation(
        [{c: torch.as_tensor(v) for c, v in p.items()} for p in pays])
    for c in CHANNELS:
        np.testing.assert_array_equal(tg[c].numpy(), np.asarray(jg[c]))


# ---------------------------------------------------------- collect_ring ---
def test_collect_ring_matches_pallas_collect_ring():
    """The port's zero-copy producer against the reference's with the
    Pallas megakernel (interpret): ring slot 1 of 2 to atol 2e-5 (rewards
    2e-4, the reference's own env tolerance), dones exact, the other slot
    keeps its sentinel, bootstrap and final obs to 2e-5, env bookkeeping
    exact."""
    N, T, S, slot = 8, 4, 2, 1
    jenv = jax_make_env("Ant", megakernel=True)
    tenv = interop.env_like("Ant", jenv.mega, megakernel=True)
    spec = jenv.spec
    params = jax_init_policy(jax.random.key(0), spec.policy_dims)
    es, obs = jenv.reset(jax.random.PRNGKey(1), num_envs=N)
    es = es._replace(t=es.t.at[jnp.array([1, 6])].set(
        spec.max_episode_len - 2))          # two envs reset mid-rollout
    key = jax.random.PRNGKey(2)
    ring = {"obs": np.full((T, S * N, spec.obs_dim), -3.0, np.float32),
            "actions": np.full((T, S * N, spec.act_dim), -3.0, np.float32),
            "rewards": np.full((T, S * N), -3.0, np.float32),
            "dones": np.full((T, S * N), -3.0, np.float32)}
    tbufs = interop.rings(ring)
    jbufs, jes, jobs, jboot, _ = jroll.collect_ring(
        params, jenv, es, obs, key, T,
        {c: jnp.asarray(v) for c, v in ring.items()}, slot, use_pallas=True)
    noise = []
    for _ in range(T):
        key, akey = jax.random.split(key)
        noise.append(np.array(jax.random.normal(akey, (N, spec.act_dim))))
    out, tes, tobs, tboot = troll.collect_ring(
        interop.policy_params(jax.tree.map(np.array, params)), tenv,
        interop.env_state(jax.tree.map(np.array, es)),
        torch.as_tensor(np.array(obs)), None, T, tbufs, slot,
        noise=torch.as_tensor(np.stack(noise)))
    assert out is tbufs
    lo, hi = slot * N, (slot + 1) * N
    for c, atol in (("obs", 2e-5), ("actions", 2e-5), ("rewards", 2e-4)):
        np.testing.assert_allclose(tbufs[c][:, lo:hi].numpy(),
                                   np.asarray(jbufs[c][:, lo:hi]), atol=atol,
                                   err_msg=c)
    np.testing.assert_array_equal(tbufs["dones"].numpy(),
                                  np.asarray(jbufs["dones"]))
    assert tbufs["dones"][:, lo:hi].sum() >= 2       # the forced resets
    for c in ring:
        assert (tbufs[c][:, :lo] == -3.0).all(), c
    np.testing.assert_allclose(tboot.numpy(), np.asarray(jboot), atol=2e-5)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=2e-5)
    for f in ("t", "seed", "resets"):
        np.testing.assert_array_equal(getattr(tes, f).numpy(),
                                      np.asarray(getattr(jes, f)))
    np.testing.assert_allclose(tes.q.numpy(), np.asarray(jes.q), atol=2e-5)


def test_collect_ring_rejects_plain_env():
    env = interop.env_like("Ant", jax_make_env("Ant").mega)
    with pytest.raises(ValueError, match="megakernel"):
        troll.collect_ring(None, env, None, None, None, 2, {}, 0)


def test_produced_slot_is_byte_identical_to_packed_push():
    """The slot contract: a ring slot written by ``collect_ring`` through
    ``produce`` equals, byte for byte, the same rollout collected as an
    Experience and packed by ``push`` (same params, state and noise)."""
    from repro_torch.envs import make_env
    from repro_torch.models.policy import init_policy
    N, T = 6, 3
    env = make_env("BallBalance", megakernel=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = init_policy(gen, env.spec.policy_dims)
    states = {a: env.reset(gen, N) for a in (0, 1)}
    noise = {a: torch.randn((T, N, env.spec.act_dim), generator=gen)
             for a in (0, 1)}
    produced = MultiChannelPipeline([0, 1], [9])
    pushed = MultiChannelPipeline([0, 1], [9])
    for a in (0, 1):
        es, obs = states[a]

        def producer(bufs, slot):
            bufs, _, _, boot = troll.collect_ring(
                params, env, es, obs, None, T, bufs, slot, noise=noise[a])
            return bufs, boot, 7

        produced.produce(a, T, N, env.spec.obs_dim, env.spec.act_dim,
                         producer, device="cpu")
        exp, _, _ = actor_collect(params, 7, env, es, obs, None, T,
                                  noise=noise[a])
        pushed.push(a, exp)
    ((_, (got,)),) = produced.flush().items()
    ((_, (want,)),) = pushed.flush().items()
    for f in Experience._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.rewards.shape == (T, 2 * N) and int(got.actor_version) == 7


def test_pipeline_produce_delivers_and_spills():
    """``produce`` writes the ring's own slot storage; flush delivers it
    like a pushed Experience, and a full 1-slot ring spills (lossless)."""
    from repro_torch.envs import make_env
    from repro_torch.models.policy import init_policy
    ne, T = 4, 3
    env = make_env("BallBalance", megakernel=True, device="cpu")
    spec = env.spec
    gen = torch.Generator().manual_seed(0)
    params = init_policy(gen, spec.policy_dims)
    pipe = MultiChannelPipeline([0], [1], ring_slots=1)
    hold = dict(zip(("s", "o"), env.reset(gen, ne)))

    def producer(bufs, slot):
        bufs, hold["s"], hold["o"], boot = troll.collect_ring(
            params, env, hold["s"], hold["o"], gen, T, bufs, slot)
        return bufs, boot, 5

    for _ in range(2):
        pipe.produce(0, T, ne, spec.obs_dim, spec.act_dim, producer,
                     device="cpu")
    assert pipe.spill_count == 1            # slot 1 of 1 was still unread
    exps = [e for batch in pipe.flush().values() for e in batch]
    assert sum(e.rewards.numel() for e in exps) == 2 * T * ne
    for e in exps:
        assert e.obs.shape[-1] == spec.obs_dim
        assert int(e.actor_version) == 5
        assert bool(torch.isfinite(e.obs).all())


def test_pipeline_produce_rejects_overlap():
    pipe = MultiChannelPipeline([0], [1], overlap=True)
    with pytest.raises(ValueError, match="blocking"):
        pipe.produce(0, 2, 2, 3, 2, lambda bufs, slot: (bufs, 0, 0),
                     device="cpu")


# ------------------------------------------- whole pipeline vs reference ---
def _assert_same_delivery(tout, jout):
    assert sorted(tout) == sorted(jout)
    for dst in jout:
        assert len(tout[dst]) == len(jout[dst])
        for tb, jb in zip(tout[dst], jout[dst]):
            for f in Experience._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(tb, f)), np.asarray(getattr(jb, f)),
                    err_msg=f"trainer {dst} {f}")


@pytest.mark.parametrize("overlap,placed", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_pipeline_delivers_what_the_reference_delivers(overlap, placed):
    """The same interleaved schedule of pushes (bursts beyond the ring,
    skipped flushes, a trailing burst) into the reference pipeline (Pallas
    pack, interpret) and the port's: every flush delivers the same batches
    to the same trainers, exactly, and the counters agree."""
    agents, trainers = [0, 1, 2, 3], [9, 10]
    gmi_gpu = {0: 0, 1: 0, 2: 1, 3: 1, 9: 0, 10: 1} if placed else None
    jp = jch.MultiChannelPipeline(agents, trainers, gmi_gpu=gmi_gpu,
                                  overlap=overlap, use_pallas=True,
                                  interpret=True)
    tp = MultiChannelPipeline(agents, trainers, gmi_gpu=gmi_gpu,
                              overlap=overlap)
    schedule = [2, 0, 5, 4, 0, 1, 6]
    v = 0
    for r, n in enumerate(schedule):
        for i in range(n):
            v += 1
            pay = _random_payload(3, 4, 5, 2, v)
            a = agents[(r + i) % len(agents)]
            jp.push(a, ja3c.Experience(**{c: jnp.asarray(x)
                                          for c, x in pay.items()}))
            tpay = {c: torch.as_tensor(x) for c, x in pay.items()}
            tpay["actor_version"] = v
            tp.push(a, Experience(**tpay))
        if r % 3 != 2:
            _assert_same_delivery(tp.flush(), jp.flush())
    _assert_same_delivery(tp.drain(), jp.drain())
    assert tp.drain() == {} and jp.drain() == {}
    for k in ("num_transfers", "total_bytes", "ops"):
        assert getattr(tp.stats, k) == getattr(jp.stats, k), k
    assert tp.spill_count == jp.spill_count > 0
    assert tp.delivered_samples == jp.delivered_samples == v * 12
    assert tp.migrator.load == jp.migrator.load
    assert len(tp.take_transfer_samples()) == len(
        jp.take_transfer_samples())


# ------------------------------------------------- services and counters ---
def test_roundtrip_compressor_and_ucc_accounting():
    """One push round-trips; two agents concatenate along the env axis;
    MCC moves the same bytes as UCC in fewer, larger transfers."""
    pipe = MultiChannelPipeline([0, 1], [2])
    e1, e2 = _exp(base=0.0), _exp(base=100.0)
    pipe.push(0, e1)
    pipe.push(1, e2)
    (got,) = pipe.flush()[2]
    assert got.rewards.shape == (4, 12)
    assert torch.equal(got.rewards[:, :6], e1.rewards)
    assert torch.equal(got.rewards[:, 6:], e2.rewards)
    assert torch.equal(got.obs[:, :6], e1.obs)
    assert torch.equal(got.bootstrap[6:], e2.bootstrap)
    mcc = MultiChannelPipeline(list(range(4)), [10, 11])
    ucc = UniChannelPipeline([10, 11])
    for _ in range(3):
        for a in range(4):
            mcc.push(a, _exp())
            ucc.send(_exp())
        mcc.flush()
    assert mcc.stats.num_transfers < ucc.stats.num_transfers
    assert mcc.stats.bytes_per_transfer > ucc.stats.bytes_per_transfer
    assert mcc.stats.total_bytes == ucc.stats.total_bytes


def test_migrator_prefers_same_gpu_then_least_loaded():
    mig = Migrator([5, 6], gmi_gpu={5: 0, 6: 1})
    ch = {"rewards": torch.zeros((4, 8))}
    assert mig.route(ch, agent_gpu=1) == 6
    assert mig.route(ch, agent_gpu=None) == 5       # least loaded
    mig.load[5] = 100
    assert mig.route(ch, agent_gpu=None) == 6


def test_batcher_slicing_and_scalar_version():
    """Slices keep the ragged tail; every batch carries one 0-d version,
    the OLDEST merged payload's, whatever the channel's rank or type."""
    ch = {c: getattr(_exp(N=10), c) for c in CHANNELS}
    parts = Batcher(mode="slice", batch_envs=4).prepare(ch)
    assert [p.rewards.shape[1] for p in parts] == [4, 4, 2]
    assert torch.equal(torch.cat([p.rewards for p in parts], dim=1),
                       ch["rewards"])
    for v, want in ((5, 5), (torch.tensor(5, dtype=torch.int32), 5),
                    (torch.tensor([3, 5, 4], dtype=torch.int32), 3)):
        ch["actor_version"] = v
        for part in (Batcher(mode="slice", batch_envs=4).prepare(ch)
                     + Batcher(mode="stack").prepare(ch)):
            assert part.actor_version.ndim == 0
            assert part.actor_version.dtype == torch.int32
            assert int(part.actor_version) == want


def test_empty_flush_and_transfer_samples():
    """A drained pipeline's flush moves nothing; each delivering flush
    leaves one (seconds, bytes) sample; overlap delivers one round late
    but still one sample per delivering flush."""
    assert TransferStats().bytes_per_transfer == 0.0
    pipe = MultiChannelPipeline([0, 1], [9])
    pipe.push(0, _exp())
    pipe.push(1, _exp(base=10.0))
    assert pipe.flush()
    transfers = pipe.stats.num_transfers
    assert pipe.flush() == {}
    assert pipe.stats.num_transfers == transfers
    (sample,) = pipe.take_transfer_samples()
    assert sample[0] > 0.0 and sample[1] == pipe.stats.total_bytes
    assert pipe.take_transfer_samples() == []
    over = MultiChannelPipeline([0, 1], [9], overlap=True)
    over.push(0, _exp())
    assert over.flush() == {}
    assert over.take_transfer_samples() == []
    over.push(0, _exp(base=5.0))
    assert over.flush()
    assert len(over.take_transfer_samples()) == 1


def test_host_staged_and_ring_pipelines_agree():
    """Device-resident and host-staged MCC deliver identical bytes and
    identical TransferStats, with Python-int and tensor versions mixed."""
    ring = MultiChannelPipeline([0, 1], [5])
    host = HostStagedPipeline([0, 1], [5])
    for r in range(3):
        for a in range(2):
            v = r * 2 + a
            e = _exp(base=r * 10.0 + a,
                     version=v if a else torch.tensor(v, dtype=torch.int32))
            ring.push(a, e)
            host.push(a, e)
        ((rb,),), ((hb,),) = ring.flush().values(), host.flush().values()
        for f in Experience._fields:
            assert torch.equal(getattr(rb, f), getattr(hb, f)), f
    assert ring.stats.num_transfers == host.stats.num_transfers
    assert ring.stats.total_bytes == host.stats.total_bytes
    assert isinstance(Compressor().stats, TransferStats)


# -------------------------------------------------------- ring invariants --
def test_ring_wraparound_keeps_newest_in_order():
    ring = ChannelRing(slots=2)
    exps = [_exp(base=100.0 * i, version=i) for i in range(3)]
    for e in exps:
        ring.append(e)                 # 3 pushes into 2 slots: e0 evicted
    ch = ring.snapshot()
    assert ch["rewards"].shape == (4, 12)
    assert torch.equal(ch["rewards"][:, :6], exps[1].rewards)
    assert torch.equal(ch["rewards"][:, 6:], exps[2].rewards)
    assert ch["actor_version"].tolist() == [1, 2]
    assert ring.count == 0             # snapshot drains


def test_ring_partial_flush_then_refill_keeps_the_snapshot():
    """A partial snapshot hands out views of the ring's storage; the ring
    lets go of it, so the refill that follows lands elsewhere and the
    snapshot, read AFTER the refill, still holds the first push."""
    ring = ChannelRing(slots=4)
    ring.append(_exp(base=1.0))
    ch = ring.snapshot()
    assert ring.bufs is None
    ring.append(_exp(base=2.0))        # ring reusable after partial flush
    ring.append(_exp(base=3.0))
    assert ch["rewards"].shape == (4, 6)
    assert torch.equal(ch["obs"], _exp(base=1.0).obs)
    assert torch.equal(ch["rewards"], _exp(base=1.0).rewards)
    ch2 = ring.snapshot()
    assert torch.equal(ch2["obs"][:, :6], _exp(base=2.0).obs)
    assert torch.equal(ch2["obs"][:, 6:], _exp(base=3.0).obs)
    assert torch.equal(ch["obs"], _exp(base=1.0).obs)


def test_flush_routes_per_agent_group_balancing_trainers():
    """Agents on two GPUs land on BOTH co-located trainers in ONE flush."""
    gmi_gpu = {0: 0, 1: 0, 2: 1, 3: 1, 100: 0, 101: 1}
    pipe = MultiChannelPipeline([0, 1, 2, 3], [100, 101], gmi_gpu=gmi_gpu)
    for a, base in zip(range(4), (0.0, 10.0, 20.0, 30.0)):
        pipe.push(a, _exp(base=base))
    out = pipe.flush()
    assert set(out) == {100, 101}
    assert pipe.migrator.load[100] == pipe.migrator.load[101] == 12
    got = out[100][0].obs
    assert torch.equal(got[:, :6], _exp(base=0.0).obs)
    assert torch.equal(got[:, 6:], _exp(base=10.0).obs)


def test_pipeline_lossless_when_pushes_outrun_flushes():
    """A full ring spills instead of evicting: every push is delivered."""
    pipe = MultiChannelPipeline([0], [9])     # group size 1 -> 1 ring slot
    es = [_exp(base=b, version=i) for i, b in enumerate((0.0, 10.0, 20.0))]
    for e in es:
        pipe.push(0, e)
    assert pipe.spill_count == 2
    ((_, batches),) = pipe.flush().items()
    assert torch.equal(torch.cat([b.rewards for b in batches], dim=1),
                       torch.cat([e.rewards for e in es], dim=1))
    assert pipe.flush() == {}


def test_double_ring_swap_then_push_does_not_corrupt_snapshot():
    ring = ChannelRing(slots=2, double_buffered=True)
    ring.append(_exp(base=1.0, version=1))
    ring.append(_exp(base=2.0, version=2))
    snap = ring.snapshot()                 # swap: back half = pushes 1, 2
    for i, base in enumerate((3.0, 4.0, 5.0)):
        if ring.count == ring.slots:
            ring.snapshot()
        ring.append(_exp(base=base, version=3 + i))
    assert torch.equal(snap["rewards"][:, :6], _exp(base=1.0).rewards)
    assert torch.equal(snap["rewards"][:, 6:], _exp(base=2.0).rewards)
    assert snap["actor_version"].tolist() == [1, 2]


def test_overlap_flush_is_one_round_delayed_and_drain_recovers_tail():
    pipe = MultiChannelPipeline([0], [9], overlap=True)
    pipe.push(0, _exp(base=1.0, version=1))
    assert pipe.flush() == {}              # swap parked, nothing in flight
    pipe.push(0, _exp(base=2.0, version=2))
    assert _bases_of(_deliver(pipe.flush())) == [1.0]
    assert _bases_of(_deliver(pipe.drain())) == [2.0]
    assert pipe.drain() == {}


def test_overlap_spill_ordering_preserved_across_swap():
    pipe = MultiChannelPipeline([0], [9], overlap=True)
    for i, base in enumerate((1.0, 2.0, 3.0)):
        pipe.push(0, _exp(base=base, version=i + 1))
    assert pipe.spill_count == 2
    assert pipe.flush() == {}
    assert _bases_of(_deliver(pipe.drain())) == [1.0, 2.0, 3.0]


def test_overlap_interleaved_schedules_no_loss_no_dup():
    schedule = [1, 0, 3, 2, 0, 0, 5, 1]    # pushes per round (2-slot ring)
    blocking = MultiChannelPipeline([0, 1], [9])
    overlap = MultiChannelPipeline([0, 1], [9], overlap=True)
    base = 0.0
    pushed, got_b, got_o = [], [], []
    for r, n in enumerate(schedule):
        for i in range(n):
            base += 1.0
            e = _exp(base=base, version=int(base))
            pushed.append(base)
            blocking.push(i % 2, e)
            overlap.push(i % 2, e)
        if r % 3 != 2:
            got_b += _bases_of(_deliver(blocking.flush()))
            got_o += _bases_of(_deliver(overlap.flush()))
    got_b += _bases_of(_deliver(blocking.drain()))
    got_o += _bases_of(_deliver(overlap.drain()))
    assert sorted(got_o) == sorted(pushed)
    assert got_o == got_b
    assert overlap.delivered_samples == blocking.delivered_samples


def test_occupancy_high_water_and_spill_counters():
    pipe = MultiChannelPipeline([0, 1], [9], overlap=True)  # 2-slot ring
    pipe.push(0, _exp(base=1.0))
    assert pipe.ring_occupancy() == 0.5
    pipe.push(1, _exp(base=2.0))
    pipe.push(0, _exp(base=3.0))                      # spill + repush
    assert pipe.spill_count == 1
    assert pipe.take_occupancy_high_water() == 1.0
    assert pipe.occupancy_high_water == 0.0
    pipe.flush()
    assert pipe.ring_occupancy() == 0.0
    clone = pipe.clone_for([0, 1, 2], [9])
    assert clone.overlap and clone.spill_count == 0


def test_ring_rejects_a_payload_of_another_shape():
    ring = ChannelRing(slots=2)
    ring.append(_exp())
    with pytest.raises(ValueError, match="payload shapes"):
        ring.append(_exp(N=5))


def test_plain_pack_writes_only_its_slot():
    """``ref.pack_channels_ref`` (the CPU path of ``ops.pack_channels``)
    leaves every other slot untouched."""
    bufs = channel_pack.alloc_rings({c: getattr(_exp(), c) for c in
                                     CHANNELS}, 3)
    for c in bufs:
        bufs[c].fill_(-1)
    ref.pack_channels_ref(bufs, {c: getattr(_exp(base=4.0, version=8), c)
                                 for c in CHANNELS}, 1)
    assert (bufs["rewards"][:, :6] == -1).all()
    assert (bufs["rewards"][:, 12:] == -1).all()
    assert torch.equal(bufs["rewards"][:, 6:12], _exp(base=4.0).rewards)
    assert bufs["actor_version"][:, 0].tolist() == [-1, 8, -1]
    assert bufs["bootstrap"][1].tolist() == [7.0] * 6
