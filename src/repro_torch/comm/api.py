"""The Communicator — communication as a first-class subsystem object,
port of ``repro/comm/api.py``.

Every layer that used to string-pass a strategy name ("mrr"/"har"/...)
now consumes one :class:`Communicator` that owns

* the trainer instance grid — the logical (g, t[, d]) shape and,
  when running on the card, the ``GMIManager.instance_mesh`` grid (one
  CUDA stream per GMI) it maps to;
* the active reduction strategy and its grad-sync closure
  (:attr:`grad_sync_fn` — duck-typed so ``rl.ppo`` accepts a
  Communicator anywhere a ``grad_sync_fn`` callable was accepted);
* the :class:`~repro_torch.comm.select.ReduceCostModel` plus a table of
  *measured* per-strategy reduce times (:meth:`observe`), from which
  :meth:`propose_switch` answers the online controller's question: does
  the measured per-round reduce time disagree with the current choice by
  more than the re-plan hysteresis?

Strategy switches (:meth:`switch`) are pure communication plumbing — the
mesh, the measurement table, and (critically) the caller's model and
optimizer state are untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.comm.calibrate import BandwidthCalibrator
from repro_torch.comm.schedules import (STRATEGIES, lgr_allreduce,
                                        make_grad_sync, mpr_host)
from repro_torch.comm.select import (ReduceCostModel,
                                     select_reduction_strategy)

_DEFAULT_AXES = ("gpu", "inst", "dev")


def _layout_grid(layout, role: Optional[str] = None):
    """(mpl, grid, dev_per_inst, uniform, role) of a layout's trainer
    placement — the one place the instance grid is read off a layout
    (from_layout and rebind both derive through here)."""
    mpl = layout.mpl
    if not mpl:
        raise ValueError("layout has no trainer GMIs — no instance grid")
    mgr = layout.manager
    if role is None:
        role = "trainer" if mgr.gmi_to_gpu_mapping("trainer") \
            else "holistic"
    sizes = {mgr.gmis[gid].num_devices for row in mpl for gid in row}
    if len(sizes) > 1:
        # mirror instance_mesh: a resized instance must never lose chips
        # by silently planning as if every GMI were single-chip
        raise ValueError(
            f"role {role} has mixed devices-per-GMI {sorted(sizes)}; the "
            "instance grid (and its cost model) needs a uniform dev axis")
    d = max(sizes.pop(), 1)
    uniform = len({len(row) for row in mpl}) == 1
    grid = (len(mpl), max(len(row) for row in mpl))
    if d > 1:
        grid = grid + (d,)
    return mpl, grid, d, uniform, role


class Communicator:
    """Owns mesh + strategy + grad-sync closure for one trainer layout."""

    def __init__(self, strategy: str, *, mesh=None,
                 grid: Optional[Sequence[int]] = None, average: bool = True,
                 cost_model: Optional[ReduceCostModel] = None,
                 uniform: bool = True, calibrate: bool = False):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown reduction strategy {strategy!r}; "
                             f"expected one of {STRATEGIES}")
        self.strategy = strategy
        self.mesh = mesh
        self.average = average
        # False for ragged layouts (unequal GMIs per GPU): no axis mesh
        # exists, so candidates() must stay in the mpr/har set
        self.uniform = uniform
        if grid is None and mesh is not None:
            grid = tuple(int(s) for s in mesh.devices.shape)
        self.grid = tuple(int(s) for s in grid) if grid is not None else None
        if cost_model is None:
            d = self.grid[2] if self.grid and len(self.grid) > 2 else 1
            cost_model = ReduceCostModel(dev_per_inst=d)
        self.cost_model = cost_model
        # strategy -> [ema_seconds, ema_bytes, observation_count]
        self._measured: Dict[str, list] = {}
        # measured-bandwidth calibration (opt-in): steady-state observe()
        # samples and channel-transfer timings accumulate here, and once
        # the Table-2 inversion is well conditioned estimate()/best() are
        # re-scored against the fitted bandwidths instead of the defaults
        self.calibrator: Optional[BandwidthCalibrator] = None
        self._calibrated: Optional[ReduceCostModel] = None
        self._calibrated_at = -1          # calibrator.version of the cache
        if calibrate:
            self.enable_calibration()

    # ------------------------------------------------------ construction --
    @classmethod
    def from_layout(cls, layout, *, cost_model: Optional[ReduceCostModel]
                    = None, average: bool = True, with_mesh: bool = False,
                    role: Optional[str] = None,
                    calibrate: bool = False) -> Optional["Communicator"]:
        """Build from a placement layout: grid off the trainer MPL (the
        dev axis off the GMIs' device counts), strategy from Algorithm 1 —
        or the Table-2 cost model when one is supplied.  Returns ``None``
        for a serving-only layout (no gradient to reduce).  ``with_mesh``
        additionally materializes ``instance_mesh`` (the instance grid on
        the layout manager's card) so :meth:`allreduce` can run.
        """
        mpl = layout.mpl
        if not mpl:
            return None
        mpl, grid, d, uniform, role = _layout_grid(layout, role)
        cm = cost_model if cost_model is not None \
            else ReduceCostModel(dev_per_inst=d)
        if cm.dev_per_inst != d:
            cm = dataclasses.replace(cm, dev_per_inst=d)
        strategy = select_reduction_strategy(
            mpl, cm if cost_model is not None else None)
        if strategy not in cm.candidates(grid, uniform):
            # Algorithm 1 is dev-blind: on a (g, t, d) grid its answer can
            # be infeasible (e.g. "mrr" when t*d > g breaks the one-ring-
            # endpoint-per-chip rule) — fall back to the cheapest feasible
            # candidate rather than construct an unswitchable state
            strategy = cm.best(grid, uniform)
        mesh = layout.manager.instance_mesh(role) if with_mesh else None
        return cls(strategy, mesh=mesh, grid=grid, average=average,
                   cost_model=cm, uniform=uniform, calibrate=calibrate)

    def rebind(self, layout) -> "Communicator":
        """Re-derive the instance grid from a re-planned layout IN PLACE
        (the controller and runner share this object).  Measured reduce
        times are cleared — they were taken against the old grid — and
        the active strategy is coerced to a feasible candidate of the new
        one (cost-scored best when the current choice no longer fits).
        CALIBRATION observations survive: bandwidths are machine
        properties, not layout properties, and every observation carries
        the grid it was measured on — only the calibrator's base model is
        refreshed to track the new dev axis.  The mesh, if any, is NOT
        rebuilt here: mesh-attached communicators belong to
        launchers that own their own re-layout."""
        mpl, grid, d, uniform, _ = _layout_grid(layout)
        self.grid = grid
        self.uniform = uniform
        if self.cost_model.dev_per_inst != d:
            self.cost_model = dataclasses.replace(self.cost_model,
                                                  dev_per_inst=d)
        self._measured.clear()
        if self.calibrator is not None:
            self.calibrator.base = self.cost_model
            self._calibrated_at = -1         # re-derive from the new base
        if self.strategy not in self.candidates():
            self.strategy = self.effective_cost_model.best(grid, uniform)
        return self

    # ---------------------------------------------------------- reduce ----
    @property
    def axes(self) -> Tuple[str, ...]:
        if self.mesh is not None:
            return tuple(self.mesh.axis_names)
        n = len(self.grid) if self.grid else 2
        return _DEFAULT_AXES[:n]

    @property
    def num_instances(self) -> int:
        if self.grid is None:
            return 1
        n = 1
        for s in self.grid:
            n *= s
        return n

    @property
    def grad_sync_fn(self):
        """Gradient-sync closure for the active strategy.

        Identity when no instance mesh is attached (a single logical
        instance, or the multi-GMI loops where cross-instance sync happens
        at the parameter level).  With a mesh attached, this is the
        collective closure of one ``torch.distributed`` rank — it needs
        per-axis process groups (``schedules.axis_groups``) and raises
        without them; GMIs that share one process want :meth:`allreduce`
        over grid-stacked gradients instead."""
        if self.mesh is None:
            return lambda grads: grads
        return make_grad_sync(self.strategy, self.axes, average=self.average)

    def allreduce(self, grads):
        """Full LGR reduction of a (g, t[, d], ...) gradient grid over the
        attached instance grid (one process, grid-stacked tensors)."""
        if self.mesh is None:
            raise ValueError(
                "Communicator has no instance mesh attached — build with "
                "from_layout(..., with_mesh=True) or pass mesh=")
        return lgr_allreduce(grads, self.mesh, self.strategy,
                             average=self.average)

    def reduce_host(self, grads_per_instance):
        """Host-staged MPR reduction (submesh/MIG-like backend)."""
        return mpr_host(grads_per_instance, average=self.average)

    # ------------------------------------------- measured-cost feedback ---
    def observe(self, seconds: float, nbytes: Optional[float] = None,
                strategy: Optional[str] = None):
        """Record one measured reduce round (EMA over rounds).  ``nbytes``
        defaults to the cost model's bytes-per-round when the caller
        cannot cheaply size the gradient tree.

        The FIRST observation per strategy is provisional: on any jitted
        path it is the compile round — exactly the stale one-off sample
        the ``switch()`` docstring warns about — so the second observation
        RESEEDS the EMA instead of averaging against it (a 100x compile
        round would otherwise contaminate the EMA for ~7 half-lives).
        Only steady-state samples (second onward) feed the calibrator.
        """
        s = strategy or self.strategy
        if nbytes is None:
            nbytes = self.cost_model.bytes_per_round
        rec = self._measured.get(s)
        if rec is None:
            self._measured[s] = [float(seconds), float(nbytes), 1]
            return
        if rec[2] == 1:
            # discard the provisional compile-round sample entirely
            self._measured[s] = [float(seconds), float(nbytes), 2]
        else:
            a = 0.5                          # smooth but responsive
            rec[0] = (1 - a) * rec[0] + a * float(seconds)
            rec[1] = (1 - a) * rec[1] + a * float(nbytes)
            rec[2] += 1
        if self.calibrator is not None and self.grid is not None:
            self.calibrator.add(s, self.grid, seconds, float(nbytes))

    def observe_transfer(self, seconds: float, nbytes: float):
        """Feed one per-round channel-transfer timing (experience moved
        over the instance-level domain) into the calibration fit as B1
        evidence.  No-op unless calibration is enabled."""
        if self.calibrator is not None:
            self.calibrator.add_transfer(seconds, nbytes)

    def measured(self, strategy: Optional[str] = None) -> Optional[float]:
        rec = self._measured.get(strategy or self.strategy)
        return rec[0] if rec else None

    def measurements(self) -> Dict[str, Tuple[float, float, int]]:
        """Per-strategy ``(ema_seconds, ema_bytes, count)`` snapshot of
        the live table (telemetry/inspection; the calibrator is fed
        sample by sample from ``observe()``, not from these EMAs)."""
        return {s: (rec[0], rec[1], rec[2])
                for s, rec in self._measured.items()}

    # --------------------------------------------------- calibration ------
    def enable_calibration(self, **knobs) -> BandwidthCalibrator:
        """Attach a :class:`BandwidthCalibrator` (idempotent).  From here
        on, steady-state ``observe()`` samples and ``observe_transfer()``
        timings accumulate toward a measured-bandwidth fit, and
        ``estimate()``/``best()``/``propose_switch()`` re-score against
        the calibrated model the moment it is well conditioned."""
        if self.calibrator is None:
            self.calibrator = BandwidthCalibrator(base=self.cost_model,
                                                  **knobs)
        return self.calibrator

    def calibrated_cost_model(self) -> Optional[ReduceCostModel]:
        """The measured-bandwidth ``ReduceCostModel``, or ``None`` while
        calibration is disabled or the fit is still ill-conditioned.
        Cached per calibrator version — refitting is cheap but not free
        on the per-round path."""
        if self.calibrator is None:
            return None
        if self._calibrated_at != self.calibrator.version:
            self._calibrated = self.calibrator.calibrated_model()
            self._calibrated_at = self.calibrator.version
        return self._calibrated

    @property
    def calibrated(self) -> bool:
        return self.calibrated_cost_model() is not None

    @property
    def effective_cost_model(self) -> ReduceCostModel:
        """What scoring actually runs against: the calibrated model once
        one exists, the static-default ``cost_model`` until then."""
        cm = self.calibrated_cost_model()
        return cm if cm is not None else self.cost_model

    def candidates(self):
        if self.grid is None:
            return [self.strategy]
        return self.effective_cost_model.candidates(self.grid, self.uniform)

    def estimate(self, strategy: Optional[str] = None,
                 nbytes: Optional[float] = None) -> float:
        """Table-2 predicted reduce seconds on this grid — against the
        calibrated bandwidths once the fit is conditioned."""
        if self.grid is None:
            raise ValueError("Communicator has no instance grid")
        return self.effective_cost_model.time(
            strategy or self.strategy, self.grid, nbytes)

    def propose_switch(self, min_gain: float = 1.05,
                       min_count: int = 3) -> Optional[str]:
        """The strategy the measured evidence says we should be running,
        or ``None`` to stay put.

        Candidates with their own steady-state measurements answer with
        measured time; unmeasured candidates answer with the Table-2
        estimate (calibrated bandwidths once available) scaled by the
        current strategy's measured/modelled ratio (so the model's
        absolute bandwidth guesses cancel out and only the *relative*
        Table-2 structure is trusted).  A switch needs ``min_count``
        observations of the current strategy — one GC pause or compile
        round must never trigger a drain-free switch — and the current
        measured time to exceed the best alternative by ``min_gain``,
        the same hysteresis the controller applies to layout re-plans.
        """
        cur = self._measured.get(self.strategy)
        if cur is None or self.grid is None or cur[2] < min_count:
            return None
        t_cur, nbytes, _ = cur
        model_cur = self.estimate(self.strategy, nbytes)
        scale = t_cur / model_cur if model_cur > 0.0 else 1.0
        best, best_t = self.strategy, t_cur
        for s in self.candidates():
            if s == self.strategy:
                continue
            rec = self._measured.get(s)
            # a candidate's lone sample is its compile round: fall back
            # to the scaled model until it has a steady-state record
            t_s = rec[0] if rec and rec[2] >= 2 \
                else self.estimate(s, nbytes) * scale
            if t_s < best_t:
                best, best_t = s, t_s
        if best != self.strategy and t_cur > min_gain * best_t:
            return best
        return None

    def propose_probe(self) -> Optional[str]:
        """A feasible candidate strategy the calibration fit still lacks
        measurements for, or ``None``.  The controller schedules the
        probe as an in-place strategy switch (Algorithm 2's explore step
        applied to communication): without it a fit over a single
        strategy stays ill-conditioned forever.  ``None`` while the
        CURRENT strategy's calibration cell is still filling — a probe
        in progress is left alone until it has the samples it was
        scheduled for, so every candidate is visited once, not bounced
        to and revisited.  Only meaningful while calibration is on."""
        if self.calibrator is None or self.grid is None:
            return None
        cur = self._measured.get(self.strategy)
        if cur is None or cur[2] < 2:
            return None              # measure where we stand first
        if self.calibrator.samples(self.strategy, self.grid) \
                < self.calibrator.min_count:
            return None              # current probe still collecting
        for s in self.candidates():
            if s == self.strategy:
                continue
            if self.calibrator.samples(s, self.grid) \
                    < self.calibrator.min_count:
                return s
        return None

    def switch(self, strategy: str) -> "Communicator":
        """Swap the active reduction strategy in place (the grad-sync
        closure follows through :attr:`grad_sync_fn`).  Mesh and cost
        model persist, and nothing about the caller's model/optimizer
        state is involved.  Measurements of OTHER strategies are dropped:
        a stale one-off sample (compile round, GC pause) would otherwise
        outrank the model forever and permanently exclude a strategy that
        is never active to re-measure itself.  Calibration observations
        persist — the fit wants evidence from every strategy, and its
        conditioning checks guard it against sparse cells.  Returns
        self."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown reduction strategy {strategy!r}; "
                             f"expected one of {STRATEGIES}")
        if self.grid is not None and strategy not in self.candidates():
            raise ValueError(
                f"strategy {strategy!r} is not feasible on instance grid "
                f"{self.grid} (candidates: {self.candidates()})")
        self.strategy = strategy
        self._measured = {k: v for k, v in self._measured.items()
                          if k == strategy}
        return self

    def __repr__(self):
        calib = "off" if self.calibrator is None else \
            ("fit" if self.calibrated else "collecting")
        return (f"Communicator(strategy={self.strategy!r}, grid={self.grid},"
                f" axes={self.axes}, average={self.average}, "
                f"measured={sorted(self._measured)}, calibration={calib})")


def as_grad_sync(fn_or_comm):
    """Normalize a grad-sync argument: a Communicator yields its closure,
    a callable (or None) passes through — the duck-typing that lets every
    pre-existing ``grad_sync_fn=`` call site keep working."""
    return getattr(fn_or_comm, "grad_sync_fn", fn_or_comm)
