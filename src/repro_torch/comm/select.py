"""Reduction-strategy selection: Algorithm 1 (shape) + Table 2 (cost).
A copy of ``repro/comm/select.py`` (framework-free).

The paper's Algorithm 1 picks MPR/MRR/HAR from the trainer-GMI placement
list alone — a static shape test.  That is kept verbatim in
:func:`algorithm1` and remains the default.  Layered on top is a
Table-2-backed cost estimate (:class:`ReduceCostModel`): candidates that
are *feasible* for the layout are scored with measured bytes-per-round and
per-axis bandwidths, which is what lets the online controller revisit the
choice from live reduce-time measurements (the communication/compute
balance is workload-dependent — arXiv:2012.04210 — so strategy choice
belongs in the measured-cost loop, not a one-shot shape test).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.comm.schedules import STRATEGIES

# NOTE: repro_torch.comm sits BELOW repro_torch.core in the layering
# (core.placement imports this module), so the Table-2 time functions from
# repro_torch.core.cost_model are imported lazily inside
# ReduceCostModel.coeffs.


# ----------------------------------------------------------- Algorithm 1 ---
def algorithm1(mpl: List[List[int]]) -> str:
    """Paper Algorithm 1, verbatim logic.

    mpl[g] = list of (trainer) GMI ids on GPU g.
    Returns one of "mpr" | "mrr" | "har".
    """
    if not mpl or not any(mpl):
        # no trainer GMIs at all: there is no gradient to reduce, and
        # answering "mpr" would let a serving-only layout silently wire
        # up a reduction schedule
        raise ValueError(
            "empty MPL — a layout with no trainer GMIs has no reduction "
            "strategy")
    gmi_per_gpu = set()
    # all GMIs on the same GPU -> plain multi-process reduction
    if len(mpl) <= 1:
        return "mpr"
    for gmi_li in mpl:
        gmi_per_gpu.add(len(gmi_li))
    # different GPUs host different numbers of GMIs
    if len(gmi_per_gpu) > 1:
        return "har"
    # more GMIs per GPU than GPUs: MRR's final ring would need >1 endpoint
    # on one GPU ("multiple CUDA streams error" in NCCL; one ICI ring
    # endpoint per chip here)
    if gmi_per_gpu.pop() > len(mpl):
        return "har"
    return "mrr"


# -------------------------------------------------------- Table-2 scoring --
@dataclass(frozen=True)
class ReduceCostModel:
    """Table-2 reduce-time estimates over the strategy candidates.

    Bandwidths follow the repo's Table-2 convention: ``bw_intra`` (B1) is
    the instance-level domain (host-staged / shared-GPU traffic between
    GMIs), ``bw_gpu`` (B2) the cross-GPU interconnect, and ``bw_dev``
    (B3) the intra-instance chip links — the fastest tier, which only the
    3-level schedule exploits.  ``bytes_per_round`` is Mp, ideally the
    *measured* delivered gradient bytes per reduction round;
    ``dev_per_inst`` is the trailing ``dev``-axis size of the instance
    grid (1 for single-chip GMIs).
    """
    bw_intra: float = 5e9        # B1: inst-level (host/shared-GPU) domain
    bw_gpu: float = 200e9        # B2: cross-GPU interconnect
    bw_dev: float = 400e9        # B3: intra-instance chip links
    bytes_per_round: float = 4 * 1.5e6   # Mp: SH policy, f32 (Table 7/8)
    dev_per_inst: int = 1

    def candidates(self, grid: Sequence[int],
                   uniform: bool = True) -> List[str]:
        """Strategies feasible for a (g, t[, d]) instance grid.  MRR keeps
        Algorithm 1's one-ring-endpoint-per-chip constraint (t·d ≤ g and a
        rectangular layout); HAR3 needs a real dev axis."""
        g, t, d = _grid3(grid)
        cands = ["mpr"]
        if g > 1:
            cands.append("har")
            if uniform and t * d <= g:
                cands.append("mrr")
            if uniform and d > 1:
                cands.append("har3")
        return cands

    def coeffs(self, strategy: str, grid: Sequence[int],
               nbytes: Optional[float] = None) -> Tuple[float, float, float]:
        """Per-axis coefficients ``(c1, c2, c3)`` of the Table-2 form
        ``time == c1/bw_intra + c2/bw_gpu + c3/bw_dev`` on one grid, with
        the same axis-merging conventions as :meth:`time` (the 2-level
        forms run on the merged (inst, dev) plane).  This is the design
        row the :class:`~repro_torch.comm.calibrate.BandwidthCalibrator`
        inverts — prediction and calibration share one source of truth.
        """
        from repro_torch.core.cost_model import lgr_coeffs
        g, t, d = _grid3(grid)
        mp = float(nbytes if nbytes is not None else self.bytes_per_round)
        if strategy == "har3":
            if d <= 1:
                raise ValueError("har3 needs a dev axis (dev_per_inst > 1)")
            return lgr_coeffs("har3", g, t, d, mp)
        if strategy in ("mpr", "mrr", "har"):
            # 2-level: the merged (inst, dev) plane is the intra domain
            return lgr_coeffs(strategy, g, t * d, 1, mp)
        raise ValueError(f"unknown reduction strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")

    def time(self, strategy: str, grid: Sequence[int],
             nbytes: Optional[float] = None) -> float:
        """Predicted reduce seconds for one strategy on one grid."""
        c1, c2, c3 = self.coeffs(strategy, grid, nbytes)
        return c1 / self.bw_intra + c2 / self.bw_gpu + c3 / self.bw_dev

    def best(self, grid: Sequence[int], uniform: bool = True,
             nbytes: Optional[float] = None) -> str:
        return min(self.candidates(grid, uniform),
                   key=lambda s: self.time(s, grid, nbytes))


def _grid3(grid: Sequence[int]) -> Tuple[int, int, int]:
    g, t = int(grid[0]), int(grid[1])
    d = int(grid[2]) if len(grid) > 2 else 1
    return g, t, max(d, 1)


# --------------------------------------------------------- public entry ----
def select_reduction_strategy(mpl: List[List[int]],
                              cost_model: Optional[ReduceCostModel] = None) \
        -> str:
    """Pick the reduction strategy for a trainer placement list.

    ``cost_model=None`` (every pre-existing caller) is Algorithm 1
    verbatim.  With a :class:`ReduceCostModel`, the (g, t) grid is read
    off the MPL, the dev axis off the model, and the cheapest *feasible*
    candidate wins — mpr/mrr/har/har3 scored with Table-2 times over the
    model's bytes-per-round and per-axis bandwidths.  Non-rectangular
    layouts keep Algorithm 1's constraint set (mpr/har only: the axis
    backend cannot even build a mesh for them).
    """
    shape_choice = algorithm1(mpl)          # also rejects an empty MPL
    if cost_model is None:
        return shape_choice
    g = len(mpl)
    per_gpu = {len(row) for row in mpl}
    uniform = len(per_gpu) == 1
    grid = (g, max(per_gpu), cost_model.dev_per_inst)
    if not uniform:
        # a ragged layout cannot build an axis mesh at all: candidates()
        # already restricts to the host-staged baseline and the
        # host-orchestrated hierarchy (mpr/har)
        feasible = cost_model.candidates(grid, uniform=False)
        return min(feasible, key=lambda s: cost_model.time(s, grid))
    return cost_model.best(grid, uniform=True)
