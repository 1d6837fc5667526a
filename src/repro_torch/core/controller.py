"""Online GMI management — the runtime half of Algorithm 2 (paper §5.2);
a copy of ``repro/core/controller.py`` over the port's
``core/selection.py`` and ``core/placement.py`` (the logic is
framework-free, so the port keeps its own copy rather than importing the
JAX package).

``selection.explore`` searches (GMIperGPU, num_env) *offline* with a
profiling callable and the saturation metric Sat = ΔTOP/ΔMem.  The paper's
adaptive GMI management does not stop there: the serving:training resource
split is workload-dependent (arXiv:2012.04210) and the right num_env moves
with the policy size and environment mix, so the same search has to keep
running against *live* measurements.  This controller closes that loop:

* every serve/train round the runner reports what actually happened —
  delivered samples, wall time, ring-occupancy high water, spill count,
  delivered bytes (the memory-pressure proxy) — one :class:`RoundSample`;
* every ``epoch_rounds`` rounds the samples fold into a recorded
  :class:`ProfilePoint` keyed by the live (gmi_per_gpu, num_env) and
  ``selection.explore`` re-runs over the *measured* table (unmeasured
  configs report not-runnable, so the search only walks observed ground
  and the fixed Sat rule handles flat/shrinking memory between recorded
  points);
* ring pressure drives the serving:training GPU split: any spill means
  producers genuinely outran the trainers (the ring overflowed between
  flushes) — shift one GPU from serving to training; occupancy under
  the low-water mark with no spills means trainers starve — shift one
  back.  Occupancy exactly at 1.0 is NOT pressure: a group-sized ring
  filled once per round is the healthy round-interleaved pattern;
* when the measured ladder is too thin to compute saturation for the
  current GMIperGPU, the controller proposes *probing* the next num_env
  up the sweep (Algorithm 2's explore step, now interleaved with
  exploitation);
* a re-plan is only emitted when the projected system throughput of the
  winning config beats the live config by ``min_gain`` (hysteresis —
  re-planning drains rings and resets environments, it is not free);
* with an attached :class:`repro_torch.comm.Communicator`, the reduction
  strategy joins the re-plan loop: measured per-round reduce times flow
  into the communicator (``RoundSample.reduce_s`` or direct
  ``Communicator.observe`` calls from the runner), and when
  ``propose_switch`` says the measured time disagrees with the current
  choice by more than the same ``min_gain`` hysteresis, the decision
  carries a ``reduction_strategy`` — applied by ``AsyncRunner.replan``
  as pure communication plumbing (model and optimizer state untouched).
  With calibration enabled on the communicator, those same measured
  reduce times (plus the pipeline's channel-transfer timings, forwarded
  by :meth:`OnlineGMIController.observe_pipeline`) feed a
  :class:`~repro_torch.comm.calibrate.BandwidthCalibrator`; once its Table-2
  inversion is conditioned the switch decision is scored against
  *measured* per-axis bandwidths instead of the static defaults; while
  feasible candidates remain unmeasured the controller schedules
  in-place probes of them (one visit each — a probe in progress is left
  alone until its calibration cell fills) to condition the fit.

The controller also closes the loop for the *request-serving*
half (paper §4's adaptive GMI management under inference traffic): each
serving engine's telemetry epoch (a duck-typed
:class:`repro_torch.serve.telemetry.ServingLoad` — queue depth, decode-slot
occupancy, p50/p95 latency, tok/s) folds into its own measured
ProfilePoint table via :meth:`OnlineGMIController.observe_serving`, keyed
(gmi_per_gpu, decode slots) so the slot ladder plays the role num_env
plays for rollouts.  Sustained admission backlog (every round of the
epoch ends with requests waiting and all slots busy) moves a GPU *to*
serving; an idle epoch (occupancy under the low-water mark, empty queues)
gives one back; when the split cannot grow, the controller probes the
next decode-slot count up the ladder instead (Algorithm 2's explore step
under traffic); and ``selection.explore`` re-runs over the measured
serving table under the same ``min_gain`` hysteresis.
``RequestRouter.apply_decision`` (and ``DisaggFront.apply_decision`` for
the prefill split) applies the resulting ``Decision`` by scaling its
engine set; ``maybe_replan`` is the standalone observe-then-apply
wrapper.

``plan_layout`` materializes the current decision as a
``placement.plan_async`` layout so the runner can rebuild its pipeline
between training epochs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.selection import (NUM_ENV_SWEEP, ProfilePoint,
                                        estimate_system_throughput, explore)


SLOT_SWEEP = (1, 2, 4, 8, 16, 32, 64)


@dataclass
class ControllerConfig:
    alpha: float = 0.1             # explore()'s saturation threshold
    epoch_rounds: int = 4          # rounds folded into one decision epoch
    min_gain: float = 1.05         # projected-throughput hysteresis
    occ_low: float = 0.25          # trainer starvation -> grow serving side
    num_env_sweep: Tuple[int, ...] = NUM_ENV_SWEEP
    probe: bool = True             # walk the num_env ladder when unmeasured
    slot_sweep: Tuple[int, ...] = SLOT_SWEEP  # decode-slot ladder (serving)


@dataclass
class RoundSample:
    """One serve/train round's live measurements."""
    samples: int                   # experience samples delivered to trainers
    dt: float                      # wall seconds for the round
    occupancy: float               # ring fill high-water during the round
    spills: int                    # ring-overflow spills during the round
    mem_bytes: float               # bytes moved (memory-pressure proxy)
    reduce_s: float = 0.0          # measured gradient-reduce seconds


@dataclass
class Decision:
    """A re-plan emitted between training epochs."""
    num_env: int
    gmi_per_gpu: int
    serving_gpus: int
    reason: str
    # set when the measured reduce time says the LGR schedule should
    # change; applied by the runner via Communicator.switch (no model
    # state involved)
    reduction_strategy: Optional[str] = None
    # False when ONLY the reduction strategy moved: the runner then
    # switches the communicator in place instead of paying the full
    # drain-and-rebuild re-plan
    layout_changed: bool = True
    # set by serving decisions: decode slots per engine (the serving
    # analogue of the num_env ladder); None for rollout decisions
    slots: Optional[int] = None
    # prefill-specialist GPUs carved out of the serving pool
    # (disaggregated serving); None when the epoch carried no
    # prefill/decode telemetry
    prefill_gpus: Optional[int] = None
    # staleness fence for the single-arbiter control plane: the
    # controller's ``plan_seq`` at emission time.  ``AsyncRunner.replan``
    # bumps ``plan_seq`` on every drain/rebuild, so an apply path
    # (``RequestRouter.apply_decision``) can refuse a decision computed
    # against a layout that no longer exists.
    seq: int = 0


@dataclass
class _Recorded:
    point: ProfilePoint
    epochs: int = 0


def _fold_point(table: Dict[Tuple[int, int], "_Recorded"],
                key: Tuple[int, int], top: float, mem: float) -> None:
    """Fold one measured (throughput, memory) epoch into a recorded table
    as a running mean — shared by the rollout and serving tables."""
    rec = table.get(key)
    if rec is None:
        table[key] = _Recorded(ProfilePoint(True, top, mem), 1)
        return
    n = rec.epochs
    rec.point = ProfilePoint(
        True, (rec.point.throughput * n + top) / (n + 1),
        (rec.point.memory * n + mem) / (n + 1))
    rec.epochs = n + 1


def _frozen_profile(table: Dict[Tuple[int, int], "_Recorded"]):
    """A recorded table as an ``explore``-compatible profile callable:
    measured configs answer with their point, everything else is
    not-runnable (the online search never extrapolates)."""
    frozen = {k: r.point for k, r in table.items()}

    def profile(bench: str, first: int, second: int) -> ProfilePoint:
        return frozen.get((first, second), ProfilePoint(False, 0.0, 0.0))

    return profile


class OnlineGMIController:
    """Feeds live pipeline stats back into Algorithm 2 and re-plans the
    GMI layout between training epochs."""

    def __init__(self, num_gpu: int, serving_gpus: int, gmi_per_gpu: int,
                 num_env: int, cfg: Optional[ControllerConfig] = None,
                 communicator=None):
        if not (1 <= serving_gpus < num_gpu):
            raise ValueError("need 1 <= serving_gpus < num_gpu")
        self.num_gpu = int(num_gpu)
        self.serving_gpus = int(serving_gpus)
        self.gmi_per_gpu = int(gmi_per_gpu)
        self.num_env = int(num_env)
        self.cfg = cfg or ControllerConfig()
        self.communicator = communicator
        self._table: Dict[Tuple[int, int], _Recorded] = {}
        self._epoch: List[RoundSample] = []
        self._spill_mark = 0
        self._bytes_mark = 0
        self.decisions: List[Decision] = []
        # request-serving loop: its own measured table, keyed
        # (gmi_per_gpu, decode slots) — the slot ladder is the serving
        # analogue of the num_env ladder
        self.serving_slots = 0         # learned from the first epoch
        self._serving_table: Dict[Tuple[int, int], _Recorded] = {}
        self._serving_epoch: List = []
        # disaggregated serving: prefill-specialist GPUs carved
        # out of the serving pool; 0 = aggregated (every serving GMI
        # prefills locally).  Arbitrated in _decide_serving from the
        # prefill_backlog/migrations telemetry fields.
        self.prefill_gpus = 0
        # bumped by AsyncRunner.replan on every drain/rebuild; stamped
        # onto emitted decisions as the staleness fence
        self.plan_seq = 0

    # ------------------------------------------------------- observation --
    def observe_pipeline(self, pipeline, samples: int,
                         dt: float) -> Optional[Decision]:
        """Convenience: pull occupancy/spill/bytes deltas off a
        ``MultiChannelPipeline`` after one round and :meth:`record`.
        When the communicator is calibrating, the pipeline's per-round
        channel-transfer timings are forwarded as B1 evidence."""
        if self.communicator is not None:
            take = getattr(pipeline, "take_transfer_samples", None)
            if take is not None:
                for sec, nbytes in take():
                    self.communicator.observe_transfer(sec, nbytes)
        if pipeline.spill_count < self._spill_mark \
                or pipeline.stats.total_bytes < self._bytes_mark:
            # fresh pipeline after a re-plan: counters restarted at zero
            self._spill_mark = 0
            self._bytes_mark = 0
        spills = pipeline.spill_count - self._spill_mark
        mem = pipeline.stats.total_bytes - self._bytes_mark
        self._spill_mark = pipeline.spill_count
        self._bytes_mark = pipeline.stats.total_bytes
        return self.record(RoundSample(
            samples=samples, dt=dt,
            occupancy=pipeline.take_occupancy_high_water(),
            spills=spills, mem_bytes=float(mem)))

    def record(self, sample: RoundSample) -> Optional[Decision]:
        """Fold one round in; returns a Decision at epoch boundaries when
        the measured evidence says the layout should change."""
        if self.communicator is not None and sample.reduce_s > 0.0:
            # runners that time the sync closure themselves call
            # Communicator.observe directly; this path serves external
            # callers that only report RoundSamples
            self.communicator.observe(sample.reduce_s)
        self._epoch.append(sample)
        if len(self._epoch) < self.cfg.epoch_rounds:
            return None
        rounds, self._epoch = self._epoch, []
        dt = sum(s.dt for s in rounds)
        samples = sum(s.samples for s in rounds)
        if dt <= 0.0 or samples <= 0:
            return None
        # per-serving-instance throughput, so recorded points are
        # comparable across gmi_per_gpu exactly like offline profiles
        n_inst = max(self.serving_gpus * self.gmi_per_gpu, 1)
        top = samples / dt / n_inst
        mem = sum(s.mem_bytes for s in rounds) / len(rounds)
        _fold_point(self._table, (self.gmi_per_gpu, self.num_env), top, mem)
        occ = max(s.occupancy for s in rounds)
        spills = sum(s.spills for s in rounds)
        return self._decide(occ, spills)

    # ------------------------------------------------- serving observation --
    def observe_serving(self, load) -> Optional[Decision]:
        """Fold one serving telemetry epoch (a duck-typed
        :class:`repro_torch.serve.telemetry.ServingLoad`: needs ``dt, tokens,
        occupancy_mean, queue_depth_mean, queue_depth_max, backlog,
        p95_s``; ``slots`` and ``mem_bytes`` optional) into the serving
        half of the Algorithm-2 loop.  Loads are expected at ROUTER level
        (aggregated over the serving engines, e.g.
        ``RequestRouter.take_epoch``): ``slots`` is the total decode-slot
        count, divided by the live instance count to key the measured
        table.  Emits a Decision at epoch boundaries when measured
        traffic says the serving side should grow, shrink, or
        re-shape."""
        self._serving_epoch.append(load)
        if len(self._serving_epoch) < self.cfg.epoch_rounds:
            return None
        rounds, self._serving_epoch = self._serving_epoch, []
        n_inst = max(self.serving_gpus * self.gmi_per_gpu, 1)
        # the slot ladder state follows what the telemetry says actually
        # ran — an unapplied probe decision resets here instead of
        # mis-keying every later epoch under a width that never existed
        obs = [float(getattr(l, "slots", 0)) for l in rounds]
        per_inst = int(round(sum(obs) / len(obs) / n_inst))
        if per_inst >= 1:
            self.serving_slots = per_inst
        elif self.serving_slots <= 0:
            self.serving_slots = 1
        dt = sum(l.dt for l in rounds)
        tokens = sum(l.tokens for l in rounds)
        if dt > 0.0 and tokens > 0:
            # per-serving-instance tok/s, comparable across gmi_per_gpu
            # exactly like the rollout table
            top = tokens / dt / n_inst
            mem = sum(float(getattr(l, "mem_bytes", 0.0))
                      for l in rounds) / len(rounds)
            _fold_point(self._serving_table,
                        (self.gmi_per_gpu, self.serving_slots), top, mem)
        return self._decide_serving(rounds)

    def _decide_serving(self, rounds) -> Optional[Decision]:
        cfg = self.cfg
        # sustained pressure: every round of the epoch ended with requests
        # waiting while all decode slots were busy (a transient queue
        # blip inside one round is not pressure)
        backlogged = all(l.backlog > 0 for l in rounds)
        idle = (max(l.occupancy_mean for l in rounds) <= cfg.occ_low
                and all(l.backlog == 0 for l in rounds)
                and max(l.queue_depth_max for l in rounds) == 0)
        serving = self.serving_gpus
        slots = self.serving_slots
        reason = None
        q = sum(l.queue_depth_mean for l in rounds) / len(rounds)
        p95 = max(l.p95_s for l in rounds)
        if backlogged and serving < self.num_gpu - 1:
            serving += 1
            reason = (f"serving backlog (queue={q:.1f}, "
                      f"p95={p95 * 1e3:.0f}ms): +1 serving GPU")
        elif backlogged and cfg.probe:
            # the split cannot grow: walk the decode-slot ladder instead
            # (Algorithm 2's explore step under traffic) — to the next
            # UNMEASURED rung, so a measured neighbor can't stall the walk
            nxt = next(
                (s for s in cfg.slot_sweep if s > slots
                 and (self.gmi_per_gpu, s) not in self._serving_table),
                None)
            if nxt is not None:
                slots = nxt
                reason = (f"serving backlog at max split (queue={q:.1f}): "
                          f"probe slots={nxt}")
        elif idle and serving > 1:
            serving -= 1
            occ = max(l.occupancy_mean for l in rounds)
            reason = (f"serving idle (occ={occ:.2f}, empty queue): "
                      "+1 training GPU")

        # prefill:decode arbitration inside the serving pool (disagg):
        # sustained prefill backlog moves a serving GPU to prefill duty;
        # an epoch with zero prefill work anywhere gives one back.  Only
        # active when the telemetry actually carries disagg signals —
        # aggregated fleets never enter here.
        prefill = self.prefill_gpus
        pf_back = [int(getattr(l, "prefill_backlog", 0)) for l in rounds]
        pf_migr = [int(getattr(l, "migrations", 0)) for l in rounds]
        disagg = prefill > 0 or any(pf_back) or any(pf_migr)
        if disagg:
            if all(b > 0 for b in pf_back) and prefill < serving - 1:
                prefill += 1
                note = (f"prefill backlog ({sum(pf_back)} waiting): "
                        "+1 prefill GMI")
                reason = f"{reason}; {note}" if reason else note
            elif prefill > 1 and not any(pf_back) and not any(pf_migr):
                prefill -= 1
                note = "prefill idle epoch: +1 decode GMI"
                reason = f"{reason}; {note}" if reason else note

        # explore over the measured serving table: same search, with the
        # slot ladder standing in for the num_env sweep.  The search is
        # PINNED to the live gmi_per_gpu — that knob belongs to the
        # rollout re-plan loop; a serving decision moving it would
        # corrupt the rollout table's keying without anything re-planning
        # the training side.  A just-decided probe is never overwritten:
        # exploitation waits until the probed rung has been measured.
        probing = slots != self.serving_slots
        keys = [k for k in self._serving_table if k[0] == self.gmi_per_gpu]
        if not probing and len(keys) > 1:
            slot_sweep = sorted(k[1] for k in keys)
            trace = explore(self._serving_profile(), "serving",
                            self.num_gpu, alpha=cfg.alpha,
                            gmi_per_gpu_range=[self.gmi_per_gpu],
                            num_env_sweep=slot_sweep)
            sl, _ = trace.best_config
            cur = self._serving_table.get(
                (self.gmi_per_gpu, self.serving_slots))
            cur_top = estimate_system_throughput(
                self.gmi_per_gpu, self.num_gpu,
                cur.point.throughput) if cur else 0.0
            if sl != self.serving_slots and trace.best_throughput \
                    > cfg.min_gain * max(cur_top, 1e-12):
                gain = trace.best_throughput / max(cur_top, 1e-12)
                move = (f"measured serving optimum (slots={sl}) "
                        f"projects {gain:.2f}x")
                reason = f"{reason}; {move}" if reason else move
                slots = sl

        if reason is None:
            return None
        layout_changed = (serving != self.serving_gpus
                          or slots != self.serving_slots
                          or prefill != self.prefill_gpus)
        decision = Decision(num_env=self.num_env,
                            gmi_per_gpu=self.gmi_per_gpu,
                            serving_gpus=serving,
                            reason=reason, slots=slots,
                            prefill_gpus=prefill if disagg else None,
                            layout_changed=layout_changed,
                            seq=self.plan_seq)
        self.serving_gpus = serving
        self.serving_slots = slots
        self.prefill_gpus = prefill
        self.decisions.append(decision)
        return decision

    def _serving_profile(self):
        """The measured serving table as an ``explore`` profile callable
        (slots stand in for num_env; unmeasured configs not runnable)."""
        return _frozen_profile(self._serving_table)

    # -------------------------------------------------------- Algorithm 2 --
    def recorded_profile(self):
        """The live rollout table as an ``explore``-compatible profile
        callable (measured configs answer with their recorded point,
        everything else is not-runnable)."""
        return _frozen_profile(self._table)

    def _projected(self, key: Tuple[int, int]) -> float:
        rec = self._table.get(key)
        if rec is None:
            return 0.0
        return estimate_system_throughput(key[0], self.num_gpu,
                                          rec.point.throughput)

    def propose_probe(self) -> Optional[int]:
        """Next unmeasured num_env up the sweep for the current GMIperGPU
        — Algorithm 2's explore step, taken online when the measured
        ladder cannot yet support a saturation estimate.  Once a measured
        point above the current config has turned DOWN (throughput no
        better than here), the ladder is saturated and probing stops."""
        measured = {ne: rec.point
                    for (gpg, ne), rec in self._table.items()
                    if gpg == self.gmi_per_gpu}
        cur = measured.get(self.num_env)
        if cur is not None and any(
                ne > self.num_env and p.throughput <= cur.throughput
                for ne, p in measured.items()):
            return None
        for ne in sorted(self.cfg.num_env_sweep):
            if ne > self.num_env and ne not in measured:
                return ne
        return None

    def _decide(self, occ: float, spills: int) -> Optional[Decision]:
        cfg = self.cfg
        # 1. serving:training split from ring pressure (arXiv:2012.04210:
        #    the right split is workload-dependent — re-measure, don't
        #    hard-code).  Spills are the overflow signal; a ring merely
        #    filled to 1.0 once per round is healthy.
        serving = self.serving_gpus
        split_reason = None
        if spills > 0 and serving > 1:
            serving -= 1
            split_reason = (f"ring pressure (spills={spills}, "
                            f"occ={occ:.2f}): +1 training GPU")
        elif occ <= cfg.occ_low and spills == 0 \
                and serving < self.num_gpu - 1:
            serving += 1
            split_reason = (f"trainer starvation (occ={occ:.2f}): "
                            "+1 serving GPU")

        # 2. (num_env, gmi_per_gpu) from explore over the measured table
        keys = sorted(self._table)
        gpg_range = sorted({k[0] for k in keys}, reverse=True)
        ne_sweep = sorted({k[1] for k in keys})
        best_key, best_top = None, 0.0
        if keys:
            trace = explore(self.recorded_profile(), "live", self.num_gpu,
                            alpha=cfg.alpha, gmi_per_gpu_range=gpg_range,
                            num_env_sweep=ne_sweep)
            ne, gpg = trace.best_config
            best_key, best_top = (gpg, ne), trace.best_throughput

        cur_key = (self.gmi_per_gpu, self.num_env)
        cur_top = self._projected(cur_key)
        reason = split_reason
        num_env, gmi_per_gpu = self.num_env, self.gmi_per_gpu
        if best_key is not None and best_key != cur_key \
                and best_top > cfg.min_gain * max(cur_top, 1e-12):
            gmi_per_gpu, num_env = best_key
            gain = best_top / max(cur_top, 1e-12)
            move = (f"measured optimum (gmi_per_gpu={gmi_per_gpu}, "
                    f"num_env={num_env}) projects {gain:.2f}x")
            reason = f"{reason}; {move}" if reason else move
        elif cfg.probe and reason is None and spills == 0:
            probe = self.propose_probe()
            if probe is not None:
                num_env = probe
                reason = (f"probe num_env={probe} (ladder unmeasured, "
                          "saturation unknown)")

        # 3. reduction strategy from measured reduce time: when the live
        #    per-round reduce measurements disagree with the current LGR
        #    choice by more than the same min_gain hysteresis, fold a
        #    strategy switch into the re-plan (Table-2 cost model —
        #    calibrated per-axis bandwidths once the fit is conditioned,
        #    the static defaults until then — scaled by the measured/
        #    modelled ratio; see Communicator).  While feasible
        #    candidates remain unmeasured, propose an in-place probe of
        #    one instead (the communication analogue of the num_env
        #    ladder walk above).
        reduction_strategy = None
        if self.communicator is not None:
            comm = self.communicator
            switch = comm.propose_switch(cfg.min_gain)
            if switch is not None:
                reduction_strategy = switch
                basis = "calibrated Table-2 bandwidths" \
                    if getattr(comm, "calibrated", False) \
                    else "default Table-2 bandwidths"
                note = (f"measured reduce time favors {switch} over "
                        f"{comm.strategy} (> {cfg.min_gain:.2f}x, "
                        f"{basis})")
                reason = f"{reason}; {note}" if reason else note
            elif cfg.probe and reason is None:
                probe_strategy = comm.propose_probe() \
                    if hasattr(comm, "propose_probe") else None
                if probe_strategy is not None:
                    reduction_strategy = probe_strategy
                    reason = (f"probe reduction strategy {probe_strategy} "
                              "(unmeasured by the bandwidth calibration)")

        if reason is None:
            return None
        layout_changed = (serving != self.serving_gpus
                          or num_env != self.num_env
                          or gmi_per_gpu != self.gmi_per_gpu)
        decision = Decision(num_env=num_env, gmi_per_gpu=gmi_per_gpu,
                            serving_gpus=serving,
                            reason=reason,
                            reduction_strategy=reduction_strategy,
                            layout_changed=layout_changed,
                            seq=self.plan_seq)
        self.num_env = num_env
        self.gmi_per_gpu = gmi_per_gpu
        self.serving_gpus = serving
        self.decisions.append(decision)
        return decision

    # ------------------------------------------------------- persistence --
    def state_dict(self) -> dict:
        """The controller's learned state as a JSON-serializable dict —
        the measured rollout/serving tables plus the committed knobs —
        for the checkpoint manifest (``AsyncRunner.checkpoint``).  Losing
        these to a preemption would restart Algorithm 2's online search
        from scratch; the epoch-in-progress sample buffers are cheap and
        deliberately not persisted."""

        def dump(table):
            return [[k[0], k[1], rec.point.throughput, rec.point.memory,
                     rec.epochs] for k, rec in sorted(table.items())]

        return {"num_gpu": self.num_gpu,
                "serving_gpus": self.serving_gpus,
                "gmi_per_gpu": self.gmi_per_gpu,
                "num_env": self.num_env,
                "serving_slots": self.serving_slots,
                "prefill_gpus": self.prefill_gpus,
                "plan_seq": self.plan_seq,
                "table": dump(self._table),
                "serving_table": dump(self._serving_table)}

    def load_state_dict(self, state: dict) -> None:
        def parse(rows):
            return {(int(a), int(b)):
                    _Recorded(ProfilePoint(True, float(top), float(mem)),
                              int(epochs))
                    for a, b, top, mem, epochs in rows}

        self.num_gpu = int(state["num_gpu"])
        self.serving_gpus = int(state["serving_gpus"])
        self.gmi_per_gpu = int(state["gmi_per_gpu"])
        self.num_env = int(state["num_env"])
        self.serving_slots = int(state.get("serving_slots", 0))
        self.prefill_gpus = int(state.get("prefill_gpus", 0))
        self.plan_seq = int(state.get("plan_seq", 0))
        self._table = parse(state.get("table", []))
        self._serving_table = parse(state.get("serving_table", []))
        self._epoch = []
        self._serving_epoch = []

    # ----------------------------------------------------------- layouts --
    def plan_layout(self, devices=None, devices_per_gpu=None,
                    device="cuda"):
        """Materialize the current decision state as an async placement
        (serving GPUs vs training GPUs, gmi_per_gpu instances each) whose
        GMIs run on ``device``."""
        from repro_torch.core.placement import plan_async
        return plan_async(self.num_gpu, self.serving_gpus, self.gmi_per_gpu,
                          devices=devices, devices_per_gpu=devices_per_gpu,
                          device=device)

    def summary(self) -> str:
        lines = [f"OnlineGMIController(num_gpu={self.num_gpu}, "
                 f"serving={self.serving_gpus}, "
                 f"gmi_per_gpu={self.gmi_per_gpu}, "
                 f"num_env={self.num_env}, "
                 f"measured={len(self._table)} configs, "
                 f"replans={len(self.decisions)})"]
        if self.communicator is not None:
            lines.append(f"  comm: {self.communicator!r}")
        for (gpg, ne), rec in sorted(self._table.items()):
            lines.append(f"  (gpg={gpg}, ne={ne}): "
                         f"top/inst={rec.point.throughput:.0f}/s "
                         f"mem={rec.point.memory:.2e}B "
                         f"epochs={rec.epochs}")
        for (gpg, sl), rec in sorted(self._serving_table.items()):
            lines.append(f"  serving (gpg={gpg}, slots={sl}): "
                         f"tok/inst={rec.point.throughput:.0f}/s "
                         f"mem={rec.point.memory:.2e}B "
                         f"epochs={rec.epochs}")
        return "\n".join(lines)
