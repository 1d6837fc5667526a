"""Parity of the port's communication subsystem (``repro_torch.comm``)
with the JAX package's on the CPU: Algorithm 1, the Table-2 cost model,
the bandwidth calibrator, the Communicator's decisions, and the LGR
schedules in both forms — grid-stacked tensors in one process, and
``torch.distributed`` collectives on 4 gloo ranks — each held against the
reference's host-staged ``mpr_host`` on the same numpy inputs.

Tolerances: the selection logic and the decisions are exact; cost-model
times rel 1e-12; calibrator fits rel 1e-9; the schedules rtol 1e-6 plus
1e-6 of each leaf's largest magnitude (the hierarchical schedules add in
another order than the host's instance-by-instance sum, and a sum of
random values can land near 0).
"""
import itertools
import multiprocessing
import socket

import numpy as np
import pytest
import torch

import _torch_gloo_worker as worker
from repro.comm import BandwidthCalibrator as JCal
from repro.comm import Communicator as JComm
from repro.comm import ReduceCostModel as JRCM
from repro.comm import algorithm1 as jalg1
from repro.comm import mpr_host as jmpr_host
from repro.comm import select_reduction_strategy as jselect
from repro.core import cost_model as jcost
from repro.core import gmi as jgmi
from repro.core import placement as jplace
from repro_torch import comm as tcomm
from repro_torch.comm import schedules as tsched
from repro_torch.core import cost_model as tcost
from repro_torch.core import gmi as tgmi
from repro_torch.core import placement as tplace

MPLS = [[[0, 1, 2]], [[0], [1]], [[0, 1], [2, 3], [4, 5]],
        [[0, 1, 2], [3, 4]], [[0, 1, 2], [3, 4, 5]], [[0, 1], [2, 3]],
        [[0], [1, 2, 3], [4]], [[0, 1, 2, 3]], [[0], [1], [2], [3]]]


# ------------------------------------------------------------ Algorithm 1 --
@pytest.mark.parametrize("mpl", MPLS, ids=str)
def test_algorithm1_and_selection_match_reference(mpl):
    """Algorithm 1 verbatim, and the Table-2 cost-scored choice at the
    default and at a dev-axis cost model, exactly equal."""
    assert tcomm.algorithm1(mpl) == jalg1(mpl)
    assert tcomm.select_reduction_strategy(mpl) == jselect(mpl)
    for kw in ({}, dict(dev_per_inst=2, bytes_per_round=6e6),
               dict(bw_intra=400e9, bw_gpu=5e9, bw_dev=50e9)):
        assert tcomm.select_reduction_strategy(
            mpl, tcomm.ReduceCostModel(**kw)) == jselect(mpl, JRCM(**kw))


def test_algorithm1_empty_mpl_raises_as_reference():
    for fn in (tcomm.algorithm1, tcomm.select_reduction_strategy):
        with pytest.raises(ValueError, match="empty MPL"):
            fn([])
    with pytest.raises(ValueError, match="empty MPL"):
        jalg1([])
    assert tcomm.STRATEGIES == ("mpr", "mrr", "har", "har3")


GRIDS3 = [(g, t, d) for g in (1, 2, 4) for t in (1, 2, 3) for d in (1, 2)]


@pytest.mark.parametrize("grid", GRIDS3, ids=str)
def test_cost_model_matches_reference(grid):
    """Candidates equal; Table-2 times and coefficients rel 1e-12, for
    every strategy and two byte counts; ``best`` equal; the module-level
    Table-2 functions too."""
    g, t, d = grid
    kw = dict(dev_per_inst=d, bytes_per_round=6e6)
    tm, jm = tcomm.ReduceCostModel(**kw), JRCM(**kw)
    for uniform in (True, False):
        assert tm.candidates(grid, uniform) == jm.candidates(grid, uniform)
    for s in tcomm.STRATEGIES:
        for nb in (None, 3.1e6):
            try:
                want = jm.time(s, grid, nb), jm.coeffs(s, grid, nb)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:20]):
                    tm.time(s, grid, nb)
                continue
            got = tm.time(s, grid, nb), tm.coeffs(s, grid, nb)
            assert got[0] == pytest.approx(want[0], rel=1e-12)
            assert got[1] == pytest.approx(want[1], rel=1e-12)
    assert tm.best(grid) == jm.best(grid)
    M, B1, B2, B3 = 1.5e6, 5e9, 200e9, 400e9
    for name in ("lgr_time_mpr", "lgr_time_mrr", "lgr_time_har"):
        assert getattr(tcost, name)(g, t, M, B1, B2) == pytest.approx(
            getattr(jcost, name)(g, t, M, B1, B2), rel=1e-12)
    assert tcost.lgr_time_har3(g, t, d, M, B1, B2, B3) == pytest.approx(
        jcost.lgr_time_har3(g, t, d, M, B1, B2, B3), rel=1e-12)
    assert tcost.best_lgr(g, t, M, B1, B2) == jcost.best_lgr(g, t, M, B1, B2)


def test_cost_model_tables_4_5_and_migration_match_reference():
    """The serving/training template models and the migration pricing."""
    for w in ({}, dict(R_s=8.0, T_s=4.0, alpha=0.3)):
        tw, jw = tcost.WorkloadProfile(**w), jcost.WorkloadProfile(**w)
        for name in ("serving_speedup_tcg_over_tdg",
                     "training_speedup_tcg_over_tdg",
                     "serving_resource_tdg", "training_resource_tdg_ex"):
            assert getattr(tcost, name)(tw) == pytest.approx(
                getattr(jcost, name)(jw), rel=1e-12)
    for args in ((4e6, 512, 50e9, 2e4), (4e6, 64, 1e9, 1e5, 1e-3)):
        assert tcost.migration_beats_local(*args) == \
            jcost.migration_beats_local(*args)
        assert tcost.migration_gain(*args) == pytest.approx(
            jcost.migration_gain(*args), rel=1e-12)
    assert tcost.migration_crossover_tokens(16, 2e5, 5e9, 1e4) == \
        jcost.migration_crossover_tokens(16, 2e5, 5e9, 1e4)
    assert tcost.dominant_resource(10, 132, 30, 80) == \
        jcost.dominant_resource(10, 132, 30, 80)


# ------------------------------------------------------------- calibrator --
def _truth(mod):
    return mod(bw_intra=400e9, bw_gpu=5e9, bw_dev=50e9, bytes_per_round=6e6,
               dev_per_inst=2)


def _samples(grid, strategies, n=3, noise=0.0, seed=0):
    """The planted-bandwidth timings of tests/test_comm.py's ``_feed``."""
    truth = _truth(JRCM)
    rng = np.random.default_rng(seed)
    return [(s, grid, truth.time(s, grid)
             * (1 + noise * rng.standard_normal()), 6e6)
            for s in strategies for _ in range(n)]


CAL_CASES = {
    "2x2": (dict(), [((2, 2), ("mpr", "mrr", "har"), 0.0, 0)], []),
    "2x2x2": (dict(dev_per_inst=2),
              [((2, 2), ("mpr", "mrr", "har"), 0.02, 0),
               ((2, 2, 2), ("mpr", "har", "har3"), 0.02, 1)], []),
    "one_strategy": (dict(), [((2, 2), ("har",), 0.0, 0)] * 7, []),
    "square": (dict(), [((2, 2), ("mpr", "har"), 0.0, 0)], []),
    "square_plus_one": (dict(), [((2, 2), ("mpr", "har"), 0.0, 0),
                                 ((4, 2), ("har",), 0.0, 0)], []),
    "b2_only": (dict(), [((2, 2), ("mrr",), 0.0, 0),
                         ((4, 2), ("mrr",), 0.0, 0)], []),
    "b2_with_transfers": (dict(), [((2, 2), ("mrr",), 0.0, 0),
                                   ((4, 2), ("mrr",), 0.0, 0)],
                          [(1e6 / 400e9, 1e6)] * 3),
    "inconsistent": (dict(), [((2, 2), ("mpr", "mrr", "har"), 0.0, 0)],
                     "poison"),
}


@pytest.mark.parametrize("case", sorted(CAL_CASES))
def test_calibrator_matches_reference(case):
    """The planted 2x2 and 2x2x2 cases of tests/test_comm.py and its
    refusals, fed to both calibrators: the same fit within rel 1e-9 (or
    the same refusal), the same solved axes, strategies and counts."""
    base_kw, feeds, transfers = CAL_CASES[case]
    cals = [JCal(base=JRCM(bytes_per_round=6e6, **base_kw)),
            tcomm.BandwidthCalibrator(
                base=tcomm.ReduceCostModel(bytes_per_round=6e6, **base_kw))]
    for cal in cals:
        for grid, strats, noise, seed in feeds:
            for s, g, sec, nb in _samples(grid, strats, noise=noise,
                                          seed=seed):
                cal.add(s, g, sec, nb)
        if transfers == "poison":
            for _ in range(3):
                cal.add("mpr", (4, 2),
                        _truth(JRCM).time("mpr", (4, 2)) * 50.0, 6e6)
        else:
            for sec, nb in transfers:
                cal.add_transfer(sec, nb)
    want, got = cals[0].fit(), cals[1].fit()
    assert (got is None) == (want is None)
    assert cals[1].n_obs == cals[0].n_obs
    assert cals[1].version == cals[0].version
    if want is None:
        assert cals[1].calibrated_model() is None
        return
    for f in ("bw_intra", "bw_gpu", "bw_dev", "rel_residual"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-9,
                                                abs=1e-300), f
    assert (got.solved, got.strategies, got.n_obs) == \
        (want.solved, want.strategies, want.n_obs)


# ----------------------------------------------------------- Communicator --
def _ns(torch_side: bool):
    if torch_side:
        return dict(Comm=tcomm.Communicator, RCM=tcomm.ReduceCostModel,
                    Mgr=lambda *a: tgmi.GMIManager(*a, device="cpu"),
                    Layout=tplace.Layout, tcg=tplace.plan_tcg_ex_training,
                    serving=tplace.plan_tcg_serving)
    return dict(Comm=JComm, RCM=JRCM, Mgr=jgmi.GMIManager,
                Layout=jplace.Layout, tcg=jplace.plan_tcg_ex_training,
                serving=jplace.plan_tcg_serving)


def _drive(ns):
    """One sequence of Communicator decisions; returns its log."""
    Comm, RCM, Mgr, Layout = ns["Comm"], ns["RCM"], ns["Mgr"], ns["Layout"]
    log = []

    def snap(c, tag):
        log.append((tag, c.strategy, c.grid, tuple(c.axes), c.uniform,
                    c.num_instances, tuple(c.candidates()),
                    c.propose_switch(), c.propose_probe(),
                    sorted(c.measurements().items()), c.calibrated,
                    None if c.grid is None else c.estimate()))

    lay = ns["tcg"](2, 2, devices=list(range(4)), devices_per_gpu=2)
    c = Comm.from_layout(lay)
    snap(c, "from_layout 2x2")
    assert Comm.from_layout(ns["serving"](2, 2, devices=list(range(8)),
                                          devices_per_gpu=4)) is None
    mgr = Mgr(list(range(8)), 4)
    for gid, gpu in [(0, 0), (1, 0), (2, 1), (3, 1)]:
        mgr.add_gmi(gid, "trainer", 0.5)
        mgr.set_gpu(gid, gpu)
    lay3 = Layout("t", mgr, [], [0, 1, 2, 3])
    c3 = Comm.from_layout(lay3, cost_model=RCM(bytes_per_round=6e6))
    snap(c3, "from_layout 2x2x2 cost")
    c3 = Comm.from_layout(lay3)
    snap(c3, "from_layout 2x2x2")
    for sec in (100.0, 1.0, 1.0, 0.8):
        c3.observe(sec, 6e6)
        snap(c3, f"observe {sec}")
    c3.observe(2.0, 6e6, strategy="har3")
    c3.observe(2.0, 6e6, strategy="har3")
    snap(c3, "observe har3")
    for s in ("har3", "har", "mpr"):
        c3.switch(s)
        snap(c3, f"switch {s}")
    for bad in ("mrr", "ring"):
        try:
            c3.switch(bad)
            log.append(("switch", bad, "ok"))
        except ValueError as e:
            log.append(("switch", bad, str(e)))
    cal = c3.enable_calibration()
    assert c3.enable_calibration() is cal
    truth = _truth(RCM)
    for _ in range(3):
        c3.observe(truth.time(c3.strategy, c3.grid), 6e6)
    snap(c3, "calibrating")
    for _ in range(6):
        probe = c3.propose_probe()
        if probe is None:
            break
        c3.switch(probe)
        for _ in range(3):
            c3.observe(truth.time(probe, c3.grid), 6e6)
        snap(c3, f"probe {probe}")
    for _ in range(2):
        c3.observe_transfer(1e6 / truth.bw_intra, 1e6)
    snap(c3, "transfers")
    cm = c3.calibrated_cost_model()
    log.append(("calibrated", None if cm is None else
                (cm.bw_intra, cm.bw_gpu, cm.bw_dev)))
    mgr2 = Mgr(list(range(8)), 2)
    for gid, gpu in [(0, 0), (1, 0), (2, 1), (3, 1)]:
        mgr2.add_gmi(gid, "trainer", 0.5)
        mgr2.set_gpu(gid, gpu)
    c3.rebind(Layout("replanned", mgr2, [], [0, 1, 2, 3]))
    snap(c3, "rebind 2x2")
    log.append(("repr", repr(c3)))
    return log


def test_communicator_decisions_match_reference():
    """The reference's and the port's Communicators driven through the
    same sequence (from_layout, observe, switch, enable_calibration,
    propose_probe, observe_transfer, propose_switch, rebind) give the same
    strategies and decisions, and measured values equal to the float."""
    want, got = _drive(_ns(False)), _drive(_ns(True))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def test_communicator_guards_match_reference():
    """Unknown strategy at construction, mixed devices-per-GMI, a ragged
    layout's candidates; as_grad_sync duck-typing."""
    for Comm in (JComm, tcomm.Communicator):
        with pytest.raises(ValueError, match="unknown reduction strategy"):
            Comm("nccl", grid=(2, 2))
    for side in (False, True):
        ns = _ns(side)
        mgr = ns["Mgr"](list(range(8)), 4)
        mgr.add_gmi(0, "trainer", 0.5)
        mgr.set_gpu(0, 0)
        mgr.add_gmi(1, "trainer", 0.25)
        mgr.set_gpu(1, 1)
        with pytest.raises(ValueError, match="mixed devices-per-GMI"):
            ns["Comm"].from_layout(ns["Layout"]("m", mgr, [], [0, 1]))
        mgr = ns["Mgr"](list(range(8)), 4)
        for gid, gpu in [(0, 0), (1, 1), (2, 1)]:
            mgr.add_gmi(gid, "trainer", 0.25)
            mgr.set_gpu(gid, gpu)
        c = ns["Comm"].from_layout(ns["Layout"]("r", mgr, [], [0, 1, 2]))
        assert (c.uniform, sorted(c.candidates())) == (False, ["har", "mpr"])
    c = tcomm.Communicator("mrr", grid=(2, 2))
    g = {"w": torch.ones(3)}
    assert tcomm.as_grad_sync(c)(g)["w"] is g["w"]
    assert tcomm.as_grad_sync(None) is None


def test_make_drl_train_step_rejects_mesh_attached_communicator():
    """The reference's guard (launch/steps.py): a per-instance step cannot
    host the collective closure of a mesh-attached Communicator."""
    from repro_torch.envs import make_env
    from repro_torch.launch.steps import make_drl_train_step
    lay = tplace.plan_tcg_ex_training(2, 2, devices=list(range(4)),
                                      devices_per_gpu=2, device="cpu")
    comm = lay.communicator(with_mesh=True)
    assert comm.mesh.shape == (2, 2)
    with pytest.raises(TypeError, match="SPMD-only"):
        make_drl_train_step(make_env("Ant", device="cpu"),
                            communicator=comm)
    step, cfg = make_drl_train_step(make_env("Ant", device="cpu"))
    assert cfg.use_fused_kernels and callable(step)


# ------------------------------------------------- schedules, form (a) ----
def _grid(shape):
    """The port's instance grid of ``shape`` on the CPU, from a layout."""
    if len(shape) == 2:
        g, t = shape
        lay = tplace.plan_tcg_ex_training(g, t, devices=list(range(g * t)),
                                          devices_per_gpu=t, device="cpu")
        return lay.manager.instance_mesh("holistic")
    g, t, d = shape
    mgr = tgmi.GMIManager(list(range(g * t * d)), t * d, device="cpu")
    for gid in range(g * t):
        mgr.add_gmi(gid, "trainer", 1.0 / t)
        mgr.set_gpu(gid, gid // t)
    return mgr.instance_mesh("trainer")


def _grads(shape, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=shape + (33, 7)).astype(np.float32),
            "b": rng.normal(size=shape + (11,)).astype(np.float32)}


def _want(grads, shape, average):
    """The reference's host-staged reduction of the per-instance trees."""
    per = [{k: v[idx] for k, v in grads.items()}
           for idx in itertools.product(*map(range, shape))]
    return jmpr_host(per, average=average)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


FORM_A = [(shape, s) for shape in ((2, 4), (2, 2), (1, 3), (2, 2, 2))
          for s in ("mpr", "mrr", "har") + (("har3",) if len(shape) == 3
                                            else ())]


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("shape,strategy", FORM_A,
                         ids=[f"{s}-{'x'.join(map(str, g))}"
                              for g, s in FORM_A])
def test_lgr_allreduce_matches_reference_mpr_host(shape, strategy, average):
    """Form (a): every strategy over grids (2, 4), (2, 2), (1, 3) and
    (2, 2, 2), leaves 33 x 7 and 11 (the pad path), through the
    Communicator's ``allreduce`` on an instance grid from
    ``instance_mesh``: every cell equals the reference's ``mpr_host``."""
    grid = _grid(shape)
    assert grid.shape == shape
    assert grid.axis_names == ("gpu", "inst", "dev")[:len(shape)]
    grads = _grads(shape, 5)
    comm = tcomm.Communicator(strategy, mesh=grid, average=average)
    out = comm.allreduce({k: torch.as_tensor(v) for k, v in grads.items()})
    want = _want(grads, shape, average)
    for k in grads:
        assert out[k].shape == grads[k].shape
        for idx in itertools.product(*map(range, shape)):
            _close(out[k][idx].numpy(), want[k])


def test_lgr_allreduce_rejects_bad_inputs_as_reference():
    """Unknown strategy, fewer than two axes, har3 on two axes, and a grid
    that is neither 2-D nor 3-D: the reference's errors."""
    grid = _grid((2, 2))
    g = {"w": torch.ones(2, 2, 3)}
    with pytest.raises(ValueError, match="unknown"):
        tsched.lgr_allreduce(g, grid, "nccl")
    with pytest.raises(ValueError, match="3-axis"):
        tsched.lgr_allreduce(g, grid, "har3")
    with pytest.raises(ValueError, match="unknown"):
        tsched.make_grad_sync("nccl", ("gpu", "inst"))
    with pytest.raises(ValueError, match="at least"):
        tsched.make_grad_sync("mrr", ("gpu",))
    with pytest.raises(ValueError, match="3-axis"):
        tsched.make_grad_sync("har3", ("gpu", "inst"))

    class Grid4:
        shape = (1, 2, 2, 2)
        axis_names = ("pod", "gpu", "inst", "dev")
    with pytest.raises(ValueError, match="2-axis .* or 3-axis"):
        tsched.lgr_allreduce({"w": torch.ones(1, 2, 2, 2, 3)}, Grid4, "mrr")
    with pytest.raises(ValueError, match="does not match"):
        tsched.lgr_allreduce({"w": torch.ones(2, 3, 3)}, grid, "mrr")
    with pytest.raises(ValueError, match="groups="):
        tsched.make_grad_sync("mrr")({"w": torch.ones(3)})


def test_mpr_host_matches_reference_exactly():
    """The host-staged sum adds in instance order on both sides: equal
    bits, averaged and not."""
    rng = np.random.default_rng(2)
    per = [{"w": rng.normal(size=(5, 3)).astype(np.float32)}
           for _ in range(5)]
    for average in (True, False):
        got = tsched.mpr_host([{"w": torch.as_tensor(p["w"])} for p in per],
                              average=average)
        np.testing.assert_array_equal(got["w"].numpy(),
                                      jmpr_host(per, average=average)["w"])


# ------------------------------------------------- schedules, form (b) ----
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("shape", [(2, 2), (2, 1, 2), (1, 2, 2)], ids=str)
def test_collective_schedules_on_gloo_match_reference(shape, tmp_path):
    """Form (b): 4 gloo ranks, one per instance, each reducing its own
    tree with ``make_grad_sync`` over ``axis_groups`` (reduce-scatter per
    scatter level, all-reduce over ``gpu``, all-gather back) for every
    strategy of the grid, averaged and summed: every rank's result equals
    the reference's ``mpr_host``.  (1, 2, 2) gives har3 two scatter levels
    of size 2, where their order matters.  Joined within 120 s."""
    axes = ("gpu", "inst", "dev")[:len(shape)]
    strategies = ("mpr", "mrr", "har") + (("har3",) if len(shape) == 3
                                          else ())
    grads = _grads(shape, 9)
    per = [{k: v[idx] for k, v in grads.items()}
           for idx in itertools.product(*map(range, shape))]
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=worker.run,
                         args=(r, 4, port, shape, axes, per, strategies,
                               str(tmp_path / f"rank{r}.npz")))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive), "a gloo rank did not finish within 120 s"
    assert [p.exitcode for p in procs] == [0] * 4
    for r in range(4):
        res = np.load(tmp_path / f"rank{r}.npz")
        for s in strategies:
            for average in (True, False):
                want = jmpr_host(per, average=average)
                for k in grads:
                    _close(res[f"{s}/{average}/{k}"], want[k])
