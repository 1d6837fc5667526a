"""Task-aware GMI mapping (paper §5.1) + communication strategy selection
(paper Algorithm 1), port of ``repro/core/placement.py``.  Every template
takes ``device``, the card its manager's GMIs run on.

Layout templates:
* TCG   — serving block: simulator + agent colocated per GMI (COM = 0).
* TDG   — dedicated GMIs per task (baseline the paper argues against).
* TCG_EX— holistic training GMI: simulator + agent + trainer colocated;
          only cross-GMI traffic is gradient reduction.
* TDG_EX— dedicated trainer GMIs fed by serving GMIs.
* async — decoupled serving-GPU set and training-GPU set (§5.1, Fig 6b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

# Algorithm 1 now lives in the comm subsystem; re-exported here because
# this module was its historical home and core/__init__ + callers import
# it from placement.
from repro_torch.comm.select import select_reduction_strategy  # noqa: F401
from repro_torch.core.gmi import GMIManager


# ------------------------------------------------------------- templates ---
@dataclass
class Layout:
    name: str
    manager: GMIManager
    serving_gmis: List[int]
    trainer_gmis: List[int]

    @property
    def mpl(self):
        """Trainer-GMI placement list; ``[]`` for serving-only layouts
        (no trainers anywhere — callers must not infer a reduction)."""
        return self.manager.gmi_to_gpu_mapping("trainer") or \
            self.manager.gmi_to_gpu_mapping("holistic")

    def reduction_strategy(self, cost_model=None) -> Optional[str]:
        """Algorithm 1 over this layout's trainer GMIs (Table-2
        cost-scored when a ``ReduceCostModel`` is supplied); ``None`` for
        a serving-only layout — there is no gradient reduction to
        select."""
        mpl = self.mpl
        if not mpl:
            return None
        return select_reduction_strategy(mpl, cost_model)

    def communicator(self, cost_model=None, *, average: bool = True,
                     with_mesh: bool = False):
        """This layout's :class:`repro_torch.comm.Communicator` (``None``
        for a serving-only layout)."""
        from repro_torch.comm.api import Communicator
        return Communicator.from_layout(self, cost_model=cost_model,
                                        average=average,
                                        with_mesh=with_mesh)


def plan_tcg_serving(num_gpus: int, gmis_per_gpu: int,
                     devices=None, devices_per_gpu=None,
                     device="cuda") -> Layout:
    """DRL serving: each GMI runs simulator+agent sequentially (TCG)."""
    mgr = GMIManager(devices, devices_per_gpu, device=device)
    gid = 0
    serving = []
    for gpu in range(num_gpus):
        for _ in range(gmis_per_gpu):
            mgr.add_gmi(gid, "serving", 1.0 / gmis_per_gpu)
            mgr.set_gpu(gid, gpu)
            serving.append(gid)
            gid += 1
    return Layout("tcg_serving", mgr, serving, [])


def plan_tdg_serving(num_gpus: int, pairs_per_gpu: int,
                     devices=None, devices_per_gpu=None,
                     device="cuda") -> Layout:
    """Baseline: dedicated simulator GMIs and agent GMIs (TDG)."""
    mgr = GMIManager(devices, devices_per_gpu, device=device)
    gid = 0
    serving = []
    # paper §5.1: Rs ≈ 10 Ra -> simulator gets the big slice
    sim_frac = 0.8 / pairs_per_gpu
    agent_frac = 0.2 / pairs_per_gpu
    for gpu in range(num_gpus):
        for _ in range(pairs_per_gpu):
            mgr.add_gmi(gid, "simulator", sim_frac)
            mgr.set_gpu(gid, gpu)
            serving.append(gid)
            gid += 1
            mgr.add_gmi(gid, "agent", agent_frac)
            mgr.set_gpu(gid, gpu)
            serving.append(gid)
            gid += 1
    return Layout("tdg_serving", mgr, serving, [])


def plan_tcg_ex_training(num_gpus: int, gmis_per_gpu: int,
                         devices=None, devices_per_gpu=None,
                         device="cuda") -> Layout:
    """Sync training: holistic GMIs (sim+agent+trainer), grad-sync only."""
    mgr = GMIManager(devices, devices_per_gpu, device=device)
    gid = 0
    trainers = []
    for gpu in range(num_gpus):
        for _ in range(gmis_per_gpu):
            mgr.add_gmi(gid, "holistic", 1.0 / gmis_per_gpu)
            mgr.set_gpu(gid, gpu)
            trainers.append(gid)
            gid += 1
    return Layout("tcg_ex", mgr, trainers, trainers)


def plan_tdg_ex_training(num_gpus: int, serving_per_gpu: int,
                         trainers_per_gpu: int,
                         devices=None, devices_per_gpu=None,
                         device="cuda") -> Layout:
    """Baseline: dedicated serving GMIs + dedicated trainer GMIs."""
    mgr = GMIManager(devices, devices_per_gpu, device=device)
    gid = 0
    serving, trainers = [], []
    s_frac = 0.7 / serving_per_gpu
    t_frac = 0.3 / trainers_per_gpu
    for gpu in range(num_gpus):
        for _ in range(serving_per_gpu):
            mgr.add_gmi(gid, "serving", s_frac)
            mgr.set_gpu(gid, gpu)
            serving.append(gid)
            gid += 1
        for _ in range(trainers_per_gpu):
            mgr.add_gmi(gid, "trainer", t_frac)
            mgr.set_gpu(gid, gpu)
            trainers.append(gid)
            gid += 1
    return Layout("tdg_ex", mgr, serving, trainers)


def plan_async(num_gpus: int, serving_gpus: int, gmis_per_gpu: int,
               devices=None, devices_per_gpu=None,
               device="cuda") -> Layout:
    """Async (A3C): serving GMIs grouped on one GPU set, trainer GMIs on the
    other (Fig 6b); experience flows over the channel pipeline (§4.2)."""
    if serving_gpus >= num_gpus:
        raise ValueError("need at least one training GPU")
    mgr = GMIManager(devices, devices_per_gpu, device=device)
    gid = 0
    serving, trainers = [], []
    for gpu in range(num_gpus):
        role = "serving" if gpu < serving_gpus else "trainer"
        for _ in range(gmis_per_gpu):
            mgr.add_gmi(gid, role, 1.0 / gmis_per_gpu)
            mgr.set_gpu(gid, gpu)
            (serving if role == "serving" else trainers).append(gid)
            gid += 1
    return Layout("async", mgr, serving, trainers)
