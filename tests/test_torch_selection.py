"""Parity of the port's Algorithm 2 (``repro_torch.core.selection``) with
the JAX package's on the CPU: the reference test's analytic profiles fed
to both ``explore``s give the same trace and best config exactly; the
port's PPO profiler times runnable points on the CPU at a tiny size,
counts CUDA out-of-memory as "not runnable" and raises anything else; the
multi-GMI run executes Algorithm 2, the layout and training end to end.
"""
import math

import pytest
import torch

from repro.core import selection as jsel
from repro_torch.core import selection as tsel


def _knee(P):
    def profile(bench, gpg, ne):
        if gpg > 4:
            return P(False, 0.0, 0.0)
        return P(True, 1000.0 * min(ne, 2048) ** 0.9 / gpg ** 0.2,
                 ne * 1e6 / gpg)
    return profile, dict(num_gpu=4, alpha=0.1)


def _runnability(P):
    return (lambda b, gpg, ne: P(gpg == 1 and ne == 128, 10.0, 1.0)), \
        dict(num_gpu=1)


def _shrinking(P):
    mems = {128: 3e6, 256: 2e6, 512: 1e6}

    def profile(bench, gpg, ne):
        if gpg != 1 or ne not in mems:
            return P(False, 0.0, 0.0)
        return P(True, 100.0 * ne, mems[ne])
    return profile, dict(num_gpu=1, gmi_per_gpu_range=(1,),
                         num_env_sweep=(128, 256, 512))


def _flat(P):
    return (lambda b, gpg, ne: P(gpg == 1, 100.0, 1e6)), dict(
        num_gpu=1, gmi_per_gpu_range=(1,), num_env_sweep=(128, 256, 512))


def _contended(P):
    """Per-GMI throughput that falls with GMIs per GPU and memory that
    grows with envs: the system estimate decides."""
    def profile(bench, gpg, ne):
        return P(ne // gpg >= 64, 5e4 * math.log2(ne) / gpg ** 0.5,
                 4e3 * ne / gpg)
    return profile, dict(num_gpu=2, gmi_per_gpu_range=(4, 2, 1),
                         num_env_sweep=(64, 512, 4096, 16384))


def _nothing(P):
    return (lambda b, gpg, ne: P(False, 0.0, 0.0)), dict(num_gpu=1)


PROFILES = {"knee": _knee, "runnability": _runnability,
            "shrinking_memory": _shrinking, "flat_memory": _flat,
            "contended": _contended, "nothing_runnable": _nothing}


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_explore_matches_reference(name):
    """tests/test_core_gmi.py's analytic profiles (and two more): the same
    trace (points, profiles and Sat values), best config and projected
    throughput, exactly; or the same refusal."""
    runs = []
    for mod in (jsel, tsel):
        profile, kw = PROFILES[name](mod.ProfilePoint)
        try:
            tr = mod.explore(profile, "AT", **kw)
        except RuntimeError as e:
            runs.append(("raised", str(e)))
            continue
        runs.append((tuple((g, n, (p.runnable, p.throughput, p.memory), s)
                           for g, n, p, s in tr.points),
                     tr.best_config, tr.best_throughput))
    assert runs[1] == runs[0]


def test_estimate_system_throughput_matches_reference():
    for gpg in range(1, 13):
        for ng in (1, 2, 8):
            assert tsel.estimate_system_throughput(gpg, ng, 1234.5) == \
                jsel.estimate_system_throughput(gpg, ng, 1234.5)
    assert tsel.NUM_ENV_SWEEP == jsel.NUM_ENV_SWEEP


def test_is_resource_exhausted_matches_reference():
    """The reference's markers, plus the CUDA allocator's own error."""
    errs = [MemoryError(), RuntimeError("RESOURCE_EXHAUSTED: while trying"),
            RuntimeError("failed to allocate 2.1GiB"),
            ValueError("shape mismatch (3,) (4,)"), KeyError("x")]
    for e in errs:
        assert tsel.is_resource_exhausted(e) == jsel.is_resource_exhausted(e)
    assert tsel.is_resource_exhausted(torch.cuda.OutOfMemoryError("boom"))


def test_ppo_profiler_times_runnable_points_on_cpu():
    """At a tiny size on the CPU: a runnable point with a positive
    throughput and the reference's memory model; too few envs a GMI and a
    blown memory budget are not runnable."""
    from repro_torch.envs import SPECS
    prof = tsel.make_ppo_profiler(iters=1, device="cpu")
    p = prof("BallBalance", 1, 16)
    assert p.runnable and p.throughput > 0
    sp = SPECS["BallBalance"]
    assert p.memory == 4 * (sp.obs_dim * 2 + sp.act_dim * 2 + 8) * 32 * 16 \
        + 4e6
    assert not prof("BallBalance", 4, 16).runnable      # 4 envs a GMI
    tight = tsel.make_ppo_profiler(iters=1, mem_budget_bytes=1e6,
                                   device="cpu")("BallBalance", 1, 16)
    assert not tight.runnable and tight.memory > 0


def test_ppo_profiler_oom_is_not_runnable_and_bugs_raise(monkeypatch):
    """A CUDA out-of-memory error is Algorithm 2's 'not runnable'; a
    ValueError is a genuine bug and surfaces."""
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 2.00 GiB")

    monkeypatch.setattr("repro_torch.rl.ppo.init_train", oom)
    prof = tsel.make_ppo_profiler(iters=1, device="cpu")("BallBalance", 1,
                                                         128)
    assert not prof.runnable and prof.memory > 0

    def bug(*a, **k):
        raise ValueError("operands could not be broadcast")

    monkeypatch.setattr("repro_torch.rl.ppo.init_train", bug)
    with pytest.raises(ValueError):
        tsel.make_ppo_profiler(iters=1, device="cpu")("BallBalance", 1, 128)


def test_ppo_profiler_defaults_to_cuda():
    """Without a card the default device raises rather than timing the
    CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsel.make_ppo_profiler(iters=1)
    assert callable(tsel.make_ppo_profiler(iters=1, device="cpu"))


def test_multi_gmi_training_runs_algorithm2_then_trains():
    """The port's counterpart of examples/multi_gmi_training.py on the
    CPU: Algorithm 2 over the reduced sweep picks a runnable config, the
    TCG_EX layout and its Algorithm-1 strategy follow, and training
    returns finite params."""
    from repro_torch.launch.multi_gmi_training import main
    from repro_torch.utils import tree_leaves
    out = main(["--device", "cpu", "--env", "BallBalance", "--iters", "2"])
    num_env, gpg = out["trace"].best_config
    assert num_env in (128, 256, 512) and gpg in (1, 2)
    assert out["strategy"] == ("mrr" if gpg <= 2 else "har")
    assert len(out["metrics"]) == 2 and len(out["metrics"][0]) == 2 * gpg
    assert all(bool(torch.isfinite(p).all())
               for p in tree_leaves(out["params"]))
