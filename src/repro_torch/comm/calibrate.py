"""Measured-bandwidth calibration — closing the telemetry loop into the
Table-2 cost model: measured per-axis bandwidths replace the static
defaults.  A copy of ``repro/comm/calibrate.py`` (numpy only).

The :class:`~repro_torch.comm.select.ReduceCostModel` ships with static
per-axis bandwidth defaults (B1 instance-level domain, B2 cross-GPU
interconnect, B3 intra-instance chip links).  §5 of the paper argues
strategy selection must track the *actual* interconnect, and on hosts
where those defaults are wrong the model mis-ranks strategies
systematically (on a CPU host the host-staged mpr baseline wins while the
defaults say otherwise).  The
measurements to fix that already exist: the :class:`~repro_torch.comm.api.
Communicator` accumulates per-strategy ``(seconds, nbytes, count)``
records in ``observe()``, and ``MultiChannelPipeline`` times its per-round
channel transfers.  This module inverts the Table-2 recurrences over that
telemetry.

Every ``lgr_time_*`` form is linear in the INVERSE bandwidths::

    time(strategy, grid, Mp) = c1/B1 + c2/B2 + c3/B3

with ``(c1, c2, c3) = ReduceCostModel.coeffs(strategy, grid, Mp)`` — so a
set of measured ``(strategy, grid, Mp, seconds)`` observations is a linear
system ``A x = y`` in ``x = (1/B1, 1/B2, 1/B3)``.  The calibrator solves
it by relative-error-weighted least squares (rows are scaled by
``1/seconds`` so a 26 us mpr round and a 1.2 ms har round constrain the
fit equally in *relative* terms) and refuses to emit a model until the
system is well conditioned:

* at least ``min_strategies`` distinct evidence kinds (strategies, plus
  the channel-transfer stream) — a single strategy cannot separate the
  axes it mixes;
* at least ``min_count`` steady-state samples per (strategy, grid) cell
  (the Communicator already discards the compile-round first sample);
* full column rank over the bandwidth axes the observations actually
  touch AND at least one redundant equation (``rows > active axes`` —
  an exactly-determined system has zero residual by construction, so
  noise-corrupted timings would be accepted blindly), every fitted
  bandwidth positive and finite, and relative residual below
  ``max_rel_residual`` (a fit that cannot explain its own inputs must
  not steer strategy selection).

Axes with no evidence (e.g. B3 on a grid with no dev axis) keep the base
model's value — the emitted model is calibrated where measured and
default elsewhere, and :class:`FitResult.solved` says which is which.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.comm.select import ReduceCostModel

_AXES = ("B1", "B2", "B3")


@dataclass(frozen=True)
class FitResult:
    """One least-squares inversion of the Table-2 system."""
    bw_intra: float                # fitted (or base) B1
    bw_gpu: float                  # fitted (or base) B2
    bw_dev: float                  # fitted (or base) B3
    solved: Tuple[str, ...]        # subset of ("B1","B2","B3") actually fit
    strategies: Tuple[str, ...]    # distinct strategies that contributed
    n_obs: int                     # steady-state samples behind the fit
    rel_residual: float            # ||Ax - y|| / ||y|| in relative units

    def bandwidth(self, axis: str) -> float:
        return {"B1": self.bw_intra, "B2": self.bw_gpu,
                "B3": self.bw_dev}[axis]


@dataclass
class _Cell:
    """Running mean of one (strategy, grid) measurement stream."""
    seconds_sum: float = 0.0
    bytes_sum: float = 0.0
    count: int = 0

    def add(self, seconds: float, nbytes: float, count: int = 1):
        self.seconds_sum += float(seconds) * count
        self.bytes_sum += float(nbytes) * count
        self.count += count


class BandwidthCalibrator:
    """Fit effective B1/B2/B3 from measured reduce + transfer timings.

    ``base`` supplies the Table-2 coefficient forms and the fallback
    bandwidths for axes the observations cannot constrain; it is a plain
    attribute so a :class:`~repro_torch.comm.api.Communicator` can keep it in
    sync across layout rebinds (observations survive a rebind — bandwidths
    are machine properties, not layout properties, and every observation
    carries the grid it was measured on).

    Knobs: ``min_count`` steady-state samples per cell before it enters
    the fit, ``min_strategies`` distinct evidence kinds before any fit is
    attempted, ``max_rel_residual`` refusal threshold on the relative
    residual, ``transfer_weight`` down-weight on channel-transfer rows
    (they carry pack/dispatch overhead the reduce rows do not).
    """

    def __init__(self, base: Optional[ReduceCostModel] = None, *,
                 min_count: int = 2, min_strategies: int = 2,
                 max_rel_residual: float = 0.35,
                 transfer_weight: float = 0.25,
                 use_transfers: bool = True):
        self.base = base if base is not None else ReduceCostModel()
        self.min_count = int(min_count)
        self.min_strategies = int(min_strategies)
        self.max_rel_residual = float(max_rel_residual)
        self.transfer_weight = float(transfer_weight)
        self.use_transfers = bool(use_transfers)
        self._obs: Dict[Tuple[str, Tuple[int, ...]], _Cell] = {}
        self._transfers = _Cell()
        # bumped on every new observation so consumers can cache fits
        self.version = 0

    # ---------------------------------------------------------- feeding ---
    def add(self, strategy: str, grid, seconds: float, nbytes: float,
            count: int = 1) -> None:
        """One steady-state reduce measurement of ``strategy`` on
        ``grid`` (callers are responsible for discarding compile-round
        samples — the Communicator's ``observe()`` does)."""
        if seconds <= 0.0 or nbytes <= 0.0:
            return
        key = (strategy, tuple(int(s) for s in grid))
        self._obs.setdefault(key, _Cell()).add(seconds, nbytes, count)
        self.version += 1

    def add_transfer(self, seconds: float, nbytes: float) -> None:
        """One per-round channel-transfer timing (MultiChannelPipeline):
        ``nbytes`` moved over the instance-level domain in ``seconds`` —
        direct (down-weighted) evidence on B1."""
        if seconds <= 0.0 or nbytes <= 0.0:
            return
        self._transfers.add(seconds, nbytes)
        self.version += 1

    # ------------------------------------------------------- inspection ---
    def samples(self, strategy: str, grid) -> int:
        cell = self._obs.get((strategy, tuple(int(s) for s in grid)))
        return cell.count if cell else 0

    @property
    def transfer_count(self) -> int:
        return self._transfers.count

    @property
    def n_obs(self) -> int:
        return sum(c.count for c in self._obs.values())

    def conditioned(self) -> bool:
        return self.fit() is not None

    # ------------------------------------------------------------- fit ----
    def _rows(self) -> Tuple[List, List, List, set]:
        rows, targets, weights, kinds = [], [], [], set()
        for (strat, grid), cell in sorted(self._obs.items()):
            if cell.count < self.min_count:
                continue
            sec = cell.seconds_sum / cell.count
            mp = cell.bytes_sum / cell.count
            if sec <= 0.0 or mp <= 0.0:
                continue
            try:
                c = self.base.coeffs(strat, grid, mp)
            except ValueError:      # e.g. har3 record against a d=1 base
                continue
            rows.append(c)
            targets.append(sec)
            weights.append(math.sqrt(cell.count))
            kinds.add(strat)
        if self.use_transfers and self._transfers.count >= self.min_count:
            sec = self._transfers.seconds_sum / self._transfers.count
            mp = self._transfers.bytes_sum / self._transfers.count
            if sec > 0.0 and mp > 0.0:
                rows.append((mp, 0.0, 0.0))
                targets.append(sec)
                weights.append(self.transfer_weight
                               * math.sqrt(self._transfers.count))
                kinds.add("transfer")
        return rows, targets, weights, kinds

    def fit(self) -> Optional[FitResult]:
        """Invert the observed Table-2 system; ``None`` while the system
        is ill-conditioned (see the class docstring for the criteria)."""
        rows, targets, weights, kinds = self._rows()
        if len(kinds) < self.min_strategies or not rows:
            return None
        A = np.asarray(rows, dtype=np.float64)
        y = np.asarray(targets, dtype=np.float64)
        # scale each equation by weight/target so the lstsq minimizes
        # weighted RELATIVE error: (A_i/y_i) x = 1, weighted
        w = np.asarray(weights, dtype=np.float64)
        Aw = A * (w / y)[:, None]
        yw = w
        active = [j for j in range(3) if np.any(np.abs(A[:, j]) > 0.0)]
        if not active or len(rows) <= len(active):
            # exactly-determined systems solve with zero residual no
            # matter how noisy the timings — demand redundancy so the
            # residual gate below can actually reject a poisoned fit
            return None
        Aa = Aw[:, active]
        if np.linalg.matrix_rank(Aa) < len(active):
            return None
        x, *_ = np.linalg.lstsq(Aa, yw, rcond=None)
        if not np.all(np.isfinite(x)) or np.any(x <= 0.0):
            return None
        resid = float(np.linalg.norm(Aa @ x - yw)
                      / max(np.linalg.norm(yw), 1e-300))
        if resid > self.max_rel_residual:
            return None
        bw = [self.base.bw_intra, self.base.bw_gpu, self.base.bw_dev]
        for j, xv in zip(active, x):
            bw[j] = 1.0 / float(xv)
        return FitResult(
            bw_intra=bw[0], bw_gpu=bw[1], bw_dev=bw[2],
            solved=tuple(_AXES[j] for j in active),
            strategies=tuple(sorted(kinds - {"transfer"})),
            n_obs=self.n_obs + self._transfers.count,
            rel_residual=resid)

    def calibrated_model(self) -> Optional[ReduceCostModel]:
        """A ``ReduceCostModel`` carrying the fitted bandwidths (base
        values on unsolved axes), or ``None`` while ill-conditioned."""
        fit = self.fit()
        if fit is None:
            return None
        return replace(self.base, bw_intra=fit.bw_intra,
                       bw_gpu=fit.bw_gpu, bw_dev=fit.bw_dev)

    def __repr__(self):
        cells = {f"{s}@{g}": c.count
                 for (s, g), c in sorted(self._obs.items())}
        return (f"BandwidthCalibrator(cells={cells}, "
                f"transfers={self._transfers.count}, "
                f"conditioned={self.conditioned()})")
