"""A GMI's share of its card's SMs, on the CPU: the slot arithmetic of
``core/gmi.py::sm_partition`` for every placement template and for the
GMI counts the card's multi-GMI and disaggregated-serving runs use,
``set_gpu``'s ids and overcommit message against the JAX package's, the
green-context bookkeeping with the CUDA driver calls stubbed, and the CPU's
null scopes.  The partitions themselves are held on the card by
``chip_smoke.py``'s SM-id probe.
"""
import contextlib
import re
import types

import pytest
import torch

from repro.core import gmi as jgmi
from repro_torch.core import gmi as tgmi
from repro_torch.core import placement as tplace
from repro_torch.core import sm_partition as smp

H100_SMS = 132
G = tgmi.SM_GRANULARITY[9]

# (template, its size arguments, the logical device count per GPU): the
# templates of tests/test_torch_gmi.py, then the card's runs: TCG_EX 1 x 1,
# 1 x 2 and 1 x 4 (the multi-GMI sweep, Algorithm 2, the launcher) and a
# 16-way serving pool (one slot a disaggregated engine)
CASES = [
    ("plan_tcg_serving", (g, t), t) for g, t in ((1, 1), (2, 3), (1, 4),
                                                 (1, 16))
] + [
    ("plan_tdg_serving", (g, p), 10) for g, p in ((1, 1), (2, 2))
] + [
    ("plan_tcg_ex_training", (g, t), t)
    for g, t in ((1, 1), (1, 2), (1, 4), (2, 2), (2, 3), (4, 2))
] + [
    ("plan_tdg_ex_training", (g, s, t), 20) for g, s, t in ((1, 2, 1),
                                                            (2, 2, 2))
] + [
    ("plan_tdg_ex_training", (1, 1, 1), 10)
] + [
    ("plan_async", (g, s, t), t) for g, s, t in ((2, 1, 2), (4, 2, 2),
                                                 (3, 1, 3))
]


def _width(per_gpu):
    return H100_SMS // per_gpu // G * G


@pytest.mark.parametrize("name,args,per_gpu", CASES,
                         ids=[f"{n}{a}/{p}" for n, a, p in CASES])
def test_template_partitions(name, args, per_gpu):
    """Each GMI's slots are its ids less its pool's start, each of
    ``floor(132 / per_gpu / 8) * 8`` SMs; the GMIs of one GPU hold
    disjoint SM ranges whose union is their slots'; a GMI of every slot
    (or of a pool of one) holds the whole card; slots narrower than 8 SMs
    raise for every GMI that does not own its whole pool."""
    g = args[0]
    lay = getattr(tplace, name)(*args, devices=list(range(g * per_gpu)),
                                devices_per_gpu=per_gpu, device="cpu")
    w = _width(per_gpu)
    by_gpu = {}
    for gmi in lay.manager.gmis.values():
        slots = sorted(d - gmi.gpu_id * per_gpu for d in gmi.device_ids)
        whole = len(slots) == per_gpu
        if not whole and w < G:
            with pytest.raises(ValueError, match=re.escape(
                    f"GMI {gmi.gmi_id}: {per_gpu} slots of a card of "
                    f"{H100_SMS} SMs are narrower than the {G}-SM")):
                tgmi.sm_partition(gmi, per_gpu, H100_SMS, G)
            continue
        p = tgmi.sm_partition(gmi, per_gpu, H100_SMS, G)
        assert p.whole == whole and p.num_slots == per_gpu
        if whole:
            assert p.sms == H100_SMS and p.ranges == ((0, H100_SMS),)
            assert p.unused == 0
            continue
        assert p.slots == tuple(slots) and p.slot_sms == w
        assert p.sms == len(slots) * w
        assert p.ranges == tuple((s * w, (s + 1) * w) for s in slots)
        assert p.unused == H100_SMS - per_gpu * w
        by_gpu.setdefault(gmi.gpu_id, []).append(p)
    for parts in by_gpu.values():
        sms = [i for p in parts for a, b in p.ranges for i in range(a, b)]
        assert len(sms) == len(set(sms)), "slots of one GPU overlap"
        assert max(sms) < per_gpu * w <= H100_SMS


@pytest.mark.parametrize("per_gpu,fracs,want", [
    # 2 slots of 64, 4 of 32, 16 of 8
    (2, [0.5, 0.5], [(64, 64), (64, 64)]),
    (4, [0.25] * 4, [(32, 32)] * 4),
    (16, [1 / 16] * 16, [(8, 8)] * 16),
    # the TDG serving pair at 10 slots: 8 slots to the simulator, 2 to the
    # agent, 52 SMs left by the rounding
    (10, [0.8, 0.2], [(64, 8), (16, 8)]),
    # two slots a GMI: the union of its ids' slots
    (4, [0.5, 0.5], [(64, 32), (64, 32)]),
])
def test_worked_examples(per_gpu, fracs, want):
    mgr = tgmi.GMIManager(list(range(per_gpu)), per_gpu, device="cpu")
    for gid, f in enumerate(fracs):
        mgr.add_gmi(gid, "holistic", f)
        mgr.set_gpu(gid, 0)
    parts = [tgmi.sm_partition(mgr.gmis[i], per_gpu, H100_SMS, G)
             for i in range(len(fracs))]
    assert [(p.sms, p.slot_sms) for p in parts] == want
    if per_gpu == 10:
        assert parts[0].slots == tuple(range(8)) and parts[1].slots == (8, 9)
        assert parts[0].unused == 52
    if fracs == [0.5, 0.5] and per_gpu == 4:
        assert parts[1].ranges == ((64, 96), (96, 128))


def test_whole_card_and_narrow_slots():
    """One slot, or every slot, is the whole card at any slot count; 17
    slots of 132 SMs are narrower than 8 and a GMI of one raises, naming
    the GMI, the slot count and the SM count; a GMI with no devices
    raises."""
    for per_gpu, frac in ((1, 1.0), (17, 1.0), (4, 1.0)):
        mgr = tgmi.GMIManager(list(range(per_gpu)), per_gpu, device="cpu")
        mgr.add_gmi(3, "holistic", frac)
        mgr.set_gpu(3, 0)
        p = tgmi.sm_partition(mgr.gmis[3], per_gpu, H100_SMS, G)
        assert p.whole and p.sms == H100_SMS and p.unused == 0
    mgr = tgmi.GMIManager(list(range(17)), 17, device="cpu")
    mgr.add_gmi(5, "serving", 1 / 17)
    mgr.set_gpu(5, 0)
    with pytest.raises(ValueError, match=r"GMI 5: 17 slots of a card of "
                       r"132 SMs are narrower than the 8-SM partition"):
        tgmi.sm_partition(mgr.gmis[5], 17, H100_SMS, G)
    mgr.add_gmi(6, "serving", 1 / 17)
    with pytest.raises(ValueError, match="GMI 6 has no devices attached"):
        tgmi.sm_partition(mgr.gmis[6], 17, H100_SMS, G)


@pytest.mark.parametrize("per_gpu,calls", [
    (4, [(0, 0.5, 0), (1, 0.5, 0), (2, 0.25, 1), (3, 0.75, 1),
         (4, 0.25, 0)]),
    (16, [(i, 1 / 16, 0) for i in range(17)]),
    (10, [(0, 0.8, 0), (1, 0.2, 0), (2, 0.1, 0)]),
], ids=["4", "16", "10"])
def test_set_gpu_ids_and_overcommit_match_reference(per_gpu, calls):
    """The same add_gmi/set_gpu calls give the same ids in both packages,
    and the same overcommit ValueError when the pool runs out (each case's
    last call)."""
    mgrs = [jgmi.GMIManager(list(range(2 * per_gpu)), per_gpu),
            tgmi.GMIManager(list(range(2 * per_gpu)), per_gpu,
                            device="cpu")]
    for gid, frac, gpu in calls:
        errs = []
        for mgr in mgrs:
            mgr.add_gmi(gid, "holistic", frac)
            try:
                mgr.set_gpu(gid, gpu)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]
        assert mgrs[0].gmis[gid].device_ids == mgrs[1].gmis[gid].device_ids
    assert "resource overcommit" in errs[1]
    assert mgrs[0].summary() == mgrs[1].summary()


def test_cpu_context_scope_is_null_and_unpacks():
    """On the CPU a GMI's context has no stream, partition or green
    context, unpacks as before into (device, stream), and its scope, the
    engine's and the training launcher's are null contexts."""
    from repro_torch.launch.steps import _scope
    from repro_torch.serve import PrefillEngine, ServeEngine
    mgr = tgmi.GMIManager(list(range(4)), 4, backend="submesh",
                          device="cpu")
    mgr.add_gmi(0, "serving", 0.25)
    mgr.set_gpu(0, 0)
    ctx = mgr.submesh(0)
    dev, stream = ctx[:2]
    assert dev == torch.device("cpu") and stream is None
    assert ctx.partition is None and ctx.green is None
    assert isinstance(ctx.scope(), contextlib.nullcontext)
    assert isinstance(_scope(ctx, True), contextlib.nullcontext)
    for engine in (ServeEngine, PrefillEngine):
        assert isinstance(engine.scope(types.SimpleNamespace(gmi=ctx)),
                          contextlib.nullcontext)
    grid = mgr.instance_mesh("serving")
    assert all(isinstance(c.scope(), contextlib.nullcontext)
               for c in grid.contexts)


class _FakeDriver:
    """``core/sm_partition``'s calls as an H100 answers them: a split
    into groups of 8 SMs whose clusters can run makes at most 15."""

    def __init__(self, most=15):
        self.most = most
        self.splits, self.creates = [], []

    def split(self, device, groups, width):
        self.splits.append((groups, width))
        return (width,) * min(groups, self.most, H100_SMS // width)

    def create(self, device, groups, width, slots):
        self.creates.append((groups, width, tuple(slots)))
        return 1000 + len(self.creates), 2000 + len(self.creates), \
            width * len(slots)


@pytest.fixture
def fake_cuda(monkeypatch):
    drv = _FakeDriver()
    monkeypatch.setattr(smp, "split", drv.split)
    monkeypatch.setattr(smp, "create", drv.create)
    monkeypatch.setattr(torch.cuda, "ExternalStream",
                        lambda ptr, device=None: ("stream", ptr))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(tgmi, "_GREEN", {})
    return drv


def test_green_contexts_made_once_a_partition(fake_cuda):
    """One green context a (card, split, slots), whatever GMI asks: the
    router's resizes and the front's failovers register new GMIs on the
    same slots and get the same context.  A context draws on the split of
    its own pool's slots; a GMI of two slots gets one context over
    both."""
    dev = torch.device("cuda", 0)
    p15 = [tgmi.SMPartition((s,), 15, 8, H100_SMS, G) for s in range(15)]
    got = [tgmi.green_context(dev, p) for p in p15 + p15]
    assert got[:15] == got[15:] and len(fake_cuda.creates) == 15
    assert len({g.ctx for g in got}) == len({g.stream for g in got}) == 15
    tgmi.green_context(dev, tgmi.SMPartition((1, 2), 4, 32, H100_SMS, G))
    assert fake_cuda.creates[-1] == (4, 32, (1, 2))
    assert set(fake_cuda.splits) == {(15, 8), (4, 32)}


def test_green_context_refuses_what_the_card_cannot_split(fake_cuda,
                                                          monkeypatch):
    """No fallback: 16 slots of 8 SMs (the card makes 15 such groups), or
    a context of other than the partition's SMs, raise, and no context is
    kept; nothing is split any other way."""
    dev = torch.device("cuda", 0)
    part = tgmi.SMPartition((0,), 16, 8, H100_SMS, G)
    with pytest.raises(tgmi.PartitionError, match=re.escape(
            "NVIDIA H100 80GB HBM3: a split into 16 x 8 SMs made groups of "
            "[8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8] SMs")):
        tgmi.green_context(dev, part)
    assert fake_cuda.splits == [(16, 8)]
    monkeypatch.setattr(smp, "create",
                        lambda d, g, w, s: (1, 2, w * len(s) - 2))
    with pytest.raises(RuntimeError, match=r"holds 6 SMs, not 8"):
        tgmi.green_context(dev, tgmi.SMPartition((0,), 15, 8, H100_SMS, G))
    assert tgmi._GREEN == {}


@pytest.mark.parametrize("gmi_per_gpu", [1, 2, 4, 10, 17])
def test_algorithm2_instance_in_its_slot(gmi_per_gpu):
    """Algorithm 2's profiler runs a candidate's instance in GMI 0 of
    ``gmi_per_gpu`` one-slot GMIs: one device id, 1/gmi_per_gpu of the
    pool, the first slot of ``floor(132 / gmi_per_gpu / 8) * 8`` SMs (the
    whole card at one GMI); a layout whose slots are narrower than 8 SMs
    cannot be carved.  On the CPU the scope is null."""
    from repro_torch.core import selection as tsel
    ctx = tsel._instance_context("cpu", gmi_per_gpu)
    assert ctx.stream is None and isinstance(ctx.scope(),
                                             contextlib.nullcontext)
    gmi = tgmi.GMI(gmi_id=0, role="holistic", device_ids=[0], gpu_id=0,
                   resource_fraction=1.0 / gmi_per_gpu)
    if _width(gmi_per_gpu) < G:
        with pytest.raises(tgmi.PartitionError):
            tgmi.sm_partition(gmi, gmi_per_gpu, H100_SMS, G)
        return
    p = tgmi.sm_partition(gmi, gmi_per_gpu, H100_SMS, G)
    if gmi_per_gpu == 1:
        assert p.whole and p.sms == H100_SMS
    else:
        assert p.slots == (0,) and p.sms == _width(gmi_per_gpu)


def test_algorithm2_uncarvable_layout_not_runnable(monkeypatch):
    """A layout the card cannot carve is not runnable for Algorithm 2, as
    an overcommitted one is in the reference: its memory model is still
    reported, and nothing runs."""
    from repro_torch.core import selection as tsel

    def carve(device, gmi_per_gpu):
        raise tgmi.PartitionError(f"{gmi_per_gpu} slots do not split")
    monkeypatch.setattr(tsel, "_instance_context", carve)
    p = tsel.make_ppo_profiler(iters=1, device="cpu")("BallBalance", 16,
                                                       2048)
    assert not p.runnable and p.throughput == 0.0 and p.memory > 0
