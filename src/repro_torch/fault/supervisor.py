"""Fleet supervision: failure classification, quarantine, and lossless
recovery over the async trainer and the serving router; port of
``repro/fault/supervisor.py``.

The :class:`FleetSupervisor` is the recovery half of the fault subsystem
(:mod:`repro_torch.fault.inject` is the breakage half).  It wraps an
``AsyncRunner`` (and optionally a ``RequestRouter`` or ``DisaggFront``),
installs the injection hooks at every seam, and turns
each raised :class:`~repro_torch.fault.inject.InjectedFault` into the
paper-shaped recovery action for its class:

* **serving GMI dies** — the GPU is quarantined, the pool shrinks by one
  serving GPU, and a controller-style re-plan (``AsyncRunner.replan``
  with an explicit reduced-pool layout) drains-and-trains everything
  still buffered, rebuilds the pipeline over the survivors, and rebinds
  the communicator.  No experience sample is lost: everything already
  pushed rides the drain.
* **trainer GMI dies** — the batch it was consuming and every batch
  behind it have already been re-queued into the ring by ``_train``
  (spill-not-drop); the round's gradient is discarded, the GPU is
  quarantined, and the same reduced-pool re-plan re-delivers the spilled
  experience to the surviving trainers.
* **serving engine dies mid-decode** — ``RequestRouter.fail_engine``:
  queued requests re-route to survivors with their latency clocks
  intact, in-flight requests restart from scratch under a capped retry
  budget, deadlines keep running throughout.
* **prefill GMI dies** — classified separately from decode-engine death:
  ``DisaggFront.fail_prefill_engine`` re-routes its queued prompts to a
  surviving prefill specialist, evicts the dead source's in-flight cache
  payloads from the migration channel, and re-prefills those requests on
  survivors with their submit clocks intact — zero requests lost.
* **channel drop / poison** — the pipeline retransmits dropped flushes
  from ``_pending``; poisoned flushes reach the trainer, whose
  non-finite guard (enabled by the supervisor) discards the update
  instead of corrupting the model.
* **checkpoint tear** — periodic preemption-safe checkpoints go through
  the hardened atomic ``repro_torch.checkpoint`` writer; a scheduled
  ``ckpt_tear`` event either crashes the save mid-write (atomicity
  leaves the previous pair intact) or corrupts the finished pair
  post-hoc (``AsyncRunner.restore`` skips it and falls back).

A quarantined GPU re-enters the pool after ``probation`` consecutive
healthy rounds (re-admission is one more re-plan, growing the pool
back).  Every failure and recovery is recorded in ``failures`` /
``recoveries`` for tests and benches to assert against.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.fault.inject import (TEAR_MODES, FaultPlan,
                                      InjectedFault, make_save_crash_hook,
                                      tear_checkpoint)


class FleetSupervisor:
    """Drives ``runner.round()`` / ``router.step()`` under a
    :class:`~repro_torch.fault.inject.FaultPlan`, recovering losslessly
    from every fault class the plan can schedule.

    Parameters
    ----------
    runner : AsyncRunner
        The async trainer to supervise.  Its ``fault_hook`` /
        ``nonfinite_guard`` are installed here.
    layout : placement Layout
        The layout the runner currently runs — the device universe for
        reduced-pool re-plans.
    plan : FaultPlan, optional
        The fault schedule.  ``None`` supervises without injection (the
        hooks stay armed; real failures raised at the seams recover the
        same way).
    router : RequestRouter or DisaggFront, optional
        The serving front; engine hooks are armed on its live engine set
        (decode engines and prefill specialists) every guarded step.
    ckpt_dir / ckpt_every : periodic preemption-safe checkpointing —
        every ``ckpt_every`` rounds, params, Adam state and version plus
        counters and controller tables are checkpointed atomically.
    probation : healthy rounds before a quarantined GPU re-enters.
    max_retries : per-request restart budget after engine deaths.
    """

    def __init__(self, runner, layout, *, plan: Optional[FaultPlan] = None,
                 router=None, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0, probation: int = 2,
                 max_retries: int = 2):
        self.runner = runner
        self.router = router
        self.plan = plan
        self.layout = layout
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.probation = int(probation)
        self.max_retries = int(max_retries)

        gmis = layout.manager.gmis.values()
        gpus = {g.gpu_id for g in gmis}
        serving = {g.gpu_id for g in gmis if g.role == "serving"}
        per_gpu = {}
        for g in gmis:
            per_gpu[g.gpu_id] = per_gpu.get(g.gpu_id, 0) + 1
        self.num_gpu = len(gpus)
        self.serving_gpus = max(len(serving), 1)
        self.gmi_per_gpu = max(per_gpu.values()) if per_gpu else 1

        self.rounds_total = 0
        self.healthy_streak = 0
        self.quarantined: List[dict] = []    # {"gpu","role","round"}
        self.failures: List[dict] = []
        self.recoveries: List[dict] = []
        self.ckpt_steps: List[int] = []

        runner.fault_hook = self._runner_hook
        runner.nonfinite_guard = True
        self._install_pipe_hook()
        self._drop_mark = 0
        self._poison_mark = 0
        self._poison_batch_mark = runner.poisoned_batches

    # ------------------------------------------------------------- hooks --
    def _runner_hook(self, role: str, gmi: int) -> None:
        if self.plan is None:
            return
        kind = "kill_serving" if role == "serving" else "kill_trainer"
        ev = self.plan.take(kind, target=gmi)
        if ev is not None:
            exc = InjectedFault(ev)
            exc.victim = gmi
            exc.role = role
            raise exc

    def _pipe_hook(self, gkey, channels) -> Optional[str]:
        if self.plan is None:
            return None
        if self.plan.take("channel_drop", target=gkey) is not None:
            return "drop"
        if self.plan.take("channel_poison", target=gkey) is not None:
            return "poison"
        return None

    def _install_pipe_hook(self) -> None:
        pipe = self.runner.pipe
        if hasattr(pipe, "fault_hook"):
            pipe.fault_hook = self._pipe_hook

    def _arm_engines(self) -> None:
        if self.router is None:
            return
        for i, eng in enumerate(self.router.engines):
            eng.fault_hook = self._make_engine_hook(i)
        for i, eng in enumerate(getattr(self.router,
                                        "prefill_engines", ())):
            eng.fault_hook = self._make_engine_hook(i, kind="prefill_fail")

    def _make_engine_hook(self, index: int, kind: str = "engine_fail"):
        def hook(engine):
            if self.plan is None:
                return
            ev = self.plan.take(kind, target=index)
            if ev is not None:
                raise InjectedFault(ev, engine=engine)
        return hook

    # ---------------------------------------------------------- the loop --
    def round(self, noise=None):
        """One supervised serve->ship->train round (plus one guarded
        router step when a router is attached); ``noise`` passes through
        to ``runner.round``.  Returns the runner's (losses, staleness) —
        empty on a failed-and-recovered round."""
        if self.plan is not None:
            self.plan.advance(self.rounds_total)
        losses, stale = [], []
        try:
            losses, stale = self.runner.round(noise)
            self._on_healthy_round()
        except InjectedFault as exc:
            self._recover_runner(exc)
        self._classify_telemetry()
        if self.router is not None:
            self.step_serving()
        self.rounds_total += 1
        if self.ckpt_dir and self.ckpt_every > 0 \
                and self.rounds_total % self.ckpt_every == 0:
            if self.plan is not None:
                # checkpoint steps are stamped with the post-round count;
                # a tear scheduled for round N must be due when step N is
                # written, not one cadence later
                self.plan.advance(self.rounds_total)
            self._checkpoint()
        return losses, stale

    def run(self, rounds: int):
        """Supervise ``rounds`` rounds, then drain the tail
        (``runner.finish``) so trained_samples catches up."""
        for _ in range(rounds):
            self.round()
        return self.runner.finish()

    def step_serving(self):
        """One guarded router step: engine hooks armed on the live set
        (decode AND prefill specialists); a dying decode engine is failed
        over via ``fail_engine``, a dying prefill GMI via
        ``fail_prefill_engine`` (lossless — queued prompts and in-flight
        cache payloads re-route to survivors)."""
        self._arm_engines()
        try:
            return self.router.step()
        except Exception as exc:
            eng = getattr(exc, "engine", None)
            if eng is None:
                raise
            if eng in getattr(self.router, "prefill_engines", ()):
                self.failures.append({
                    "kind": "prefill_fail", "round": self.rounds_total,
                    "target": getattr(eng, "name", None)})
                rerouted = self.router.fail_prefill_engine(eng)
                self.recoveries.append({
                    "kind": "prefill_fail", "round": self.rounds_total,
                    "action": f"re-routed {rerouted} prompt(s)/payload(s) "
                              f"to surviving prefill GMI(s)"})
                return []
            self.failures.append({
                "kind": "engine_fail", "round": self.rounds_total,
                "target": getattr(eng, "name", None)})
            failed = self.router.fail_engine(eng, self.max_retries)
            self.recoveries.append({
                "kind": "engine_fail", "round": self.rounds_total,
                "action": f"failed over to {self.router.num_engines} "
                          f"survivor(s), {len(failed)} retry-exhausted"})
            return failed

    def drain_serving(self):
        """Guarded ``router.drain()``: step until idle, failing over any
        engine that dies on the way."""
        done = []
        while self.router is not None and self.router.busy:
            done.extend(self.step_serving() or [])
        return done

    # ----------------------------------------------------------- recovery --
    def _recover_runner(self, exc: InjectedFault) -> None:
        role = getattr(exc, "role",
                       "serving" if exc.event.kind == "kill_serving"
                       else "trainer")
        victim = getattr(exc, "victim", exc.event.target)
        gpu = None
        g = self.layout.manager.gmis.get(victim) if victim is not None \
            else None
        if g is not None:
            gpu = g.gpu_id
        self.failures.append({"kind": exc.event.kind,
                              "round": self.rounds_total,
                              "target": victim, "gpu": gpu})
        self.healthy_streak = 0
        if role == "serving":
            # the dead GMI's GPU leaves the pool as a serving GPU; the
            # floor is one serving GPU — below that the fleet restarts
            # the GMI in place instead of shrinking
            if self.serving_gpus > 1:
                self.serving_gpus -= 1
                self.num_gpu -= 1
                self.quarantined.append({"gpu": gpu, "role": "serving",
                                         "round": self.rounds_total})
                action = f"quarantined serving GPU {gpu}"
            else:
                action = "restarted last serving GPU in place"
        else:
            if self.num_gpu - 1 > self.serving_gpus:
                self.num_gpu -= 1
                self.quarantined.append({"gpu": gpu, "role": "trainer",
                                         "round": self.rounds_total})
                action = f"quarantined trainer GPU {gpu}"
            else:
                action = "restarted last trainer GPU in place"
        self._replan(f"{exc.event.kind}: {action}")
        self.recoveries.append({"kind": exc.event.kind,
                                "round": self.rounds_total,
                                "action": action,
                                "num_gpu": self.num_gpu,
                                "serving_gpus": self.serving_gpus})

    def _replan(self, reason: str) -> None:
        """Reduced/grown-pool re-plan: drain-and-train (lossless), then
        rebuild pipeline + actors + communicator binding over the new
        pool.  Bypasses the controller's own layout planning — the
        supervisor, not Algorithm 2, decides the post-failure pool."""
        from repro_torch.core.controller import Decision
        from repro_torch.core.placement import plan_async
        mgr = self.layout.manager
        layout = plan_async(self.num_gpu, self.serving_gpus,
                            self.gmi_per_gpu, devices=mgr.devices,
                            devices_per_gpu=mgr.devices_per_gpu,
                            device=mgr.device)
        decision = Decision(num_env=self.runner.num_envs,
                            gmi_per_gpu=self.gmi_per_gpu,
                            serving_gpus=self.serving_gpus,
                            reason=reason)
        self.layout = self.runner.replan(decision, layout=layout) or layout
        # clone_for starts the new pipeline without hooks — re-arm
        self._install_pipe_hook()
        self._drop_mark = 0
        self._poison_mark = 0
        ctl = self.runner.controller
        if ctl is not None:
            # the controller's notion of the fleet must track the real
            # (post-quarantine) pool, or its next decision re-plans a
            # layout over GPUs that no longer exist
            ctl.num_gpu = self.num_gpu
            ctl.serving_gpus = self.serving_gpus
            ctl.gmi_per_gpu = self.gmi_per_gpu

    def _on_healthy_round(self) -> None:
        self.healthy_streak += 1
        if self.quarantined and self.healthy_streak >= self.probation:
            back = self.quarantined.pop(0)
            self.num_gpu += 1
            if back["role"] == "serving":
                self.serving_gpus += 1
            self._replan(f"probation passed ({self.probation} healthy "
                         f"rounds): re-admitting {back['role']} GPU "
                         f"{back['gpu']}")
            self.recoveries.append({"kind": "readmit",
                                    "round": self.rounds_total,
                                    "gpu": back["gpu"],
                                    "role": back["role"],
                                    "num_gpu": self.num_gpu,
                                    "serving_gpus": self.serving_gpus})
            self.healthy_streak = 0

    def _classify_telemetry(self) -> None:
        """Classify sub-fatal faults from existing telemetry deltas:
        dropped/poisoned flush counters on the pipeline and discarded
        non-finite updates on the runner."""
        pipe = self.runner.pipe
        drops = getattr(pipe, "dropped_flushes", 0)
        poisons = getattr(pipe, "poisoned_flushes", 0)
        bad = self.runner.poisoned_batches
        if drops > self._drop_mark:
            self.failures.append({"kind": "channel_drop",
                                  "round": self.rounds_total,
                                  "count": drops - self._drop_mark})
            self.recoveries.append({"kind": "channel_drop",
                                    "round": self.rounds_total,
                                    "action": "retransmit from _pending"})
        if poisons > self._poison_mark:
            self.failures.append({"kind": "channel_poison",
                                  "round": self.rounds_total,
                                  "count": poisons - self._poison_mark})
        if bad > self._poison_batch_mark:
            self.recoveries.append({
                "kind": "channel_poison", "round": self.rounds_total,
                "action": f"discarded {bad - self._poison_batch_mark} "
                          "non-finite update(s)"})
        self._drop_mark = drops
        self._poison_mark = poisons
        self._poison_batch_mark = bad

    # --------------------------------------------------------- checkpoint --
    def _checkpoint(self) -> None:
        """Periodic preemption-safe checkpoint, honoring any scheduled
        ``ckpt_tear``: a SAVE_STAGES mode crashes the save mid-write (the
        atomic writer leaves the previous pair intact), a TEAR_MODES mode
        corrupts the finished pair post-hoc (restore must skip it)."""
        step = self.rounds_total
        ev = self.plan.take("ckpt_tear") if self.plan is not None else None
        hook = None
        if ev is not None and ev.mode is not None \
                and ev.mode not in TEAR_MODES:
            hook = make_save_crash_hook(ev.mode, ev)
        try:
            self.runner.checkpoint(self.ckpt_dir, step=step,
                                   fault_hook=hook)
            self.ckpt_steps.append(step)
        except InjectedFault:
            self.failures.append({"kind": "ckpt_tear", "round": step,
                                  "mode": ev.mode})
            self.recoveries.append({
                "kind": "ckpt_tear", "round": step,
                "action": "save crashed mid-write; previous pair intact"})
            return
        if ev is not None and (ev.mode is None or ev.mode in TEAR_MODES):
            tear_checkpoint(self.ckpt_dir, step, ev.mode or "torn_npz")
            self.failures.append({"kind": "ckpt_tear", "round": step,
                                  "mode": ev.mode or "torn_npz"})
            self.recoveries.append({
                "kind": "ckpt_tear", "round": step,
                "action": "pair corrupted post-hoc; restore will skip"})

    # ------------------------------------------------------------ queries --
    def summary(self) -> str:
        lines = [f"FleetSupervisor(rounds={self.rounds_total}, "
                 f"num_gpu={self.num_gpu}, serving={self.serving_gpus}, "
                 f"quarantined={len(self.quarantined)}, "
                 f"failures={len(self.failures)}, "
                 f"recoveries={len(self.recoveries)})"]
        for f in self.failures:
            lines.append(f"  FAIL r{f['round']}: "
                         + ", ".join(f"{k}={v}" for k, v in f.items()
                                     if k != "round"))
        for r in self.recoveries:
            lines.append(f"  RECOVER r{r['round']}: "
                         + ", ".join(f"{k}={v}" for k, v in r.items()
                                     if k != "round"))
        return "\n".join(lines)
