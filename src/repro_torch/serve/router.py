"""Multi-GMI serving front (paper §3–§4: resource-adjustable GMIs hosting
inference workloads); port of ``repro/serve/router.py``.

Each serving GMI runs its own :class:`~repro_torch.serve.engine.ServeEngine`
(in the GMI's own context, ``GMIManager.submesh``'s: its share of the
card's SMs and a stream on them, when one is attached); the
:class:`RequestRouter` is the admission/queueing layer in front:
requests route to the least-loaded engine by queue depth, and per-GMI
p50/p95 latency and tok/s accumulate in each engine's telemetry.  The
control plane is single-arbiter: epoch snapshots (``take_epoch``) feed
the ONE ``OnlineGMIController`` instance — normally
driven from the overlapped ``AsyncRunner`` round loop — and its decisions
come back through :meth:`RequestRouter.apply_decision`, a thin apply hook
guarded against stale (pre-re-plan) and double-applied decisions.
:meth:`RequestRouter.maybe_replan` is the standalone observe-then-apply
wrapper for serving-only deployments without a runner.  The
disaggregated front (:mod:`repro_torch.serve.disagg`) wraps this router for
the decode side and adds prefill specialists under the same arbiter.

:class:`ServingRole` is the concrete ``DRLRole`` for serving (paper
Listing 1): ``gmi_run(requests)`` executes the engine's request loop
inside the instance's resource slice — the GMI programming model's
serving instance.  On the port's MIG-like ``submesh`` backend that slice
is the GMI's share of the manager's card: a green context of its SMs and
that context's stream.
"""
from __future__ import annotations

import inspect
import time
import warnings
from typing import Callable, Dict, List, Optional

from repro_torch.core.gmi import DRLRole, GMIManager
from repro_torch.serve.engine import Completion, Request, ServeEngine
from repro_torch.serve.telemetry import ServingLoad, merge_loads


def _engine_load(engine, take: bool = False) -> ServingLoad:
    """One engine's epoch with its memory/page counters attached (paged
    counters are 0/0 for dense engines — getattr keeps duck-typed engine
    substitutes working)."""
    fn = engine.telemetry.take_epoch if take else engine.telemetry.snapshot
    return fn(engine.cache_bytes, getattr(engine, "free_pages", 0),
              getattr(engine, "total_pages", 0))


class RequestRouter:
    """Admission/queueing front over N serving engines.

    ``engine_factory(index) -> ServeEngine`` lets the router scale the
    worker set at runtime (:meth:`scale_to`, usually driven by a
    controller :class:`~repro_torch.core.controller.Decision`); a factory that
    also accepts a ``slots`` keyword lets the controller's decode-slot
    ladder decisions re-shape the engines (:meth:`resize_slots`).
    Constructing with a plain engine list disables scaling up beyond
    that list unless a factory is supplied too."""

    def __init__(self, engines: Optional[List[ServeEngine]] = None, *,
                 engine_factory: Optional[
                     Callable[[int], ServeEngine]] = None,
                 num_engines: Optional[int] = None):
        if engines is None and engine_factory is None:
            raise ValueError("need engines or an engine_factory")
        self._factory = engine_factory
        self._factory_takes_slots = False
        if engine_factory is not None:
            try:
                params = inspect.signature(engine_factory).parameters
                self._factory_takes_slots = "slots" in params or any(
                    p.kind == p.VAR_KEYWORD for p in params.values())
            except (TypeError, ValueError):
                pass
        self._slots: Optional[int] = None
        self._spawned = 0
        self.engines: List[ServeEngine] = list(engines or [])
        self._spawned = len(self.engines)
        if num_engines is not None:
            self.scale_to(num_engines)
        self.completions: List[Completion] = []
        # telemetry of workers retired mid-epoch: their drained tokens /
        # latencies must still reach the next take_epoch, or a scale-down
        # makes the system look idler than it was
        self._retired_loads: List[ServingLoad] = []
        self._seen_rids: set = set()
        # per-rid restart counts for requests whose engine died mid-decode
        self._retries: Dict[int, int] = {}
        self.failed_engines = 0
        # double-replan guard: the last decision object applied (a
        # decision applies at most once) — see apply_decision
        self._last_applied = None
        self.stale_decisions = 0

    # -------------------------------------------------------------- routing --
    @property
    def num_engines(self) -> int:
        return len(self.engines)

    @property
    def queue_len(self) -> int:
        return sum(e.queue_len for e in self.engines)

    @property
    def busy(self) -> bool:
        return any(e.busy for e in self.engines)

    def submit(self, req: Request) -> int:
        """Route by queue depth: the engine with the least outstanding
        work (queued + in decode slots) admits the request; ties break to
        the lowest index for determinism.  A rid this router has already
        accepted is rejected — double-submitting would double-count the
        request everywhere downstream (internal restarts after an engine
        failure go through ``_resubmit``, which bypasses this check)."""
        if not self.engines:
            raise RuntimeError("router has no engines (scaled to zero?)")
        if req.rid in self._seen_rids:
            raise ValueError(f"request {req.rid} already submitted to "
                             "this router (duplicate rid)")
        # min() is stable: ties go to the lowest-index engine
        eng = min(self.engines, key=lambda e: e.load)
        rid = eng.submit(req)
        self._seen_rids.add(rid)
        return rid

    def step(self) -> List[Completion]:
        """Advance every busy engine one decode step."""
        done: List[Completion] = []
        for e in self.engines:
            if e.busy:
                done.extend(e.step())
        self.completions.extend(done)
        return done

    def drain(self) -> List[Completion]:
        """Step until every engine is idle."""
        done: List[Completion] = []
        while self.busy:
            done.extend(self.step())
        self.completions.extend(done)
        return done

    # ------------------------------------------------------------ telemetry --
    @property
    def total_slots(self) -> int:
        """Live decode-slot capacity across the current engine set."""
        return sum(e.max_slots for e in self.engines)

    def snapshot(self) -> ServingLoad:
        """Aggregate the engines' current epochs (no reset)."""
        return merge_loads([_engine_load(e) for e in self.engines]
                           + self._retired_loads,
                           live_slots=self.total_slots)

    def take_epoch(self) -> ServingLoad:
        """Aggregate AND reset every engine's telemetry epoch — the
        router-level load the controller consumes.  Includes the final
        epochs of workers retired since the last call (their tokens and
        latencies count; the reported slot capacity is the LIVE engine
        set's, so a resize epoch never shows phantom slots)."""
        retired, self._retired_loads = self._retired_loads, []
        return merge_loads([_engine_load(e, take=True)
                            for e in self.engines] + retired,
                           live_slots=self.total_slots)

    def per_gmi_stats(self) -> List[ServingLoad]:
        """Per-engine epoch snapshots (p50/p95 + tok/s per GMI)."""
        return [_engine_load(e) for e in self.engines]

    # -------------------------------------------------------------- scaling --
    def _spawn(self, index: int) -> ServeEngine:
        if self._slots is not None and self._factory_takes_slots:
            return self._factory(index, slots=self._slots)
        return self._factory(index)

    def _retire(self, engine: ServeEngine) -> List[Request]:
        """Drain an engine being removed: in-flight slots finish, queued
        requests come back (with their original submit timestamps), and
        its final telemetry epoch is preserved for the next take_epoch."""
        pending = engine.take_queue()
        stamps = {r.rid: engine.telemetry.submit_time(r.rid, None)
                  for r in pending}
        self.completions.extend(engine.run_until_idle(admit=False))
        self._retired_loads.append(_engine_load(engine, take=True))
        for req in pending:
            req._submit_t = stamps.get(req.rid)
        return pending

    def _resubmit(self, req: Request):
        eng = min(self.engines, key=lambda e: e.load)
        t0 = getattr(req, "_submit_t", None)
        if t0 is not None:
            # keep the original arrival: on_submit setdefaults, so the
            # survivor's own submit() stamp cannot shorten the latency
            eng.telemetry.on_submit(req.rid, t0)
        eng.submit(req)

    def fail_engine(self, engine: ServeEngine,
                    max_retries: int = 2) -> List[Completion]:
        """Remove a DEAD engine and recover its requests — the lossless
        half of serving-GMI failure handling.

        Unlike :meth:`_retire` there is no drain: the engine's decode
        state is gone.  Its queued requests re-route to the survivors
        with their original submit clocks (``_resubmit``); its in-flight
        requests restart from scratch on a survivor, at most
        ``max_retries`` times each — past that they complete with status
        ``"failed"`` rather than bouncing between dying engines forever.
        Deadlines keep running through all of it: an expired restart
        times out at the survivor's admission.  The dead engine's final
        telemetry epoch is preserved for the next ``take_epoch``.
        Returns the completions produced (retry-exhausted failures)."""
        if engine not in self.engines:
            return []
        self.engines.remove(engine)
        self.failed_engines += 1
        queued = engine.take_queue()
        inflight = engine.take_inflight()
        prefilled = engine.take_prefilled() \
            if hasattr(engine, "take_prefilled") else []
        stamps = {r.rid: engine.telemetry.submit_time(r.rid, None)
                  for r in queued + inflight}
        self._retired_loads.append(_engine_load(engine, take=True))
        if not self.engines:
            raise RuntimeError(
                "last serving engine died; no survivors to fail over to")
        # not-yet-spliced migrated payloads are engine-independent: a
        # survivor splices them as-is, generation progress intact
        for pl in prefilled:
            min(self.engines, key=lambda e: e.load).submit_prefilled(pl)
        done: List[Completion] = []
        inflight_rids = {r.rid for r in inflight}
        for req in queued + inflight:
            req._submit_t = stamps.get(req.rid)
            if req.rid in inflight_rids:
                tries = self._retries.get(req.rid, 0)
                if tries >= max_retries:
                    now = time.perf_counter()
                    t0 = req._submit_t if req._submit_t is not None else now
                    done.append(Completion(
                        request=req, tokens=[],
                        prompt_tokens=len(req.tokens),
                        latency_s=now - t0, status="failed"))
                    continue
                self._retries[req.rid] = tries + 1
            self._resubmit(req)
        self.completions.extend(done)
        return done

    def scale_to(self, n: int) -> int:
        """Grow or shrink the worker set to ``n`` engines.

        Growing spawns via the factory.  Shrinking retires the
        highest-index workers: their not-yet-admitted requests re-route to
        the survivors (latency clocks intact) and their in-flight slots
        run to completion first — no request is lost or truncated."""
        n = max(int(n), 1)
        while len(self.engines) < n:
            if self._factory is None:
                # surface the shortfall loudly — a silent break here left
                # callers believing they scaled up when nothing happened
                warnings.warn(
                    f"scale_to({n}): router has no engine_factory; "
                    f"staying at {len(self.engines)} engine(s)",
                    RuntimeWarning, stacklevel=2)
                break
            self.engines.append(self._spawn(self._spawned))
            self._spawned += 1
        while len(self.engines) > n:
            for req in self._retire(self.engines.pop()):
                self._resubmit(req)
        return len(self.engines)

    def resize_slots(self, slots: int) -> bool:
        """Rebuild every engine with a new decode-slot width (the
        controller's slot-ladder decisions).  Lossless like scale-down:
        in-flight requests finish on the old engines, queued ones carry
        over.  Returns False when the factory cannot build resized
        engines."""
        if self._factory is None or not self._factory_takes_slots:
            return False
        current = self._slots or (self.engines[0].max_slots
                                  if self.engines else None)
        if int(slots) == current:
            return False
        old, self.engines = self.engines, []
        pending: List[Request] = []
        for e in old:
            pending.extend(self._retire(e))
        self._slots = int(slots)
        self.engines = [self._spawn(i) for i in range(len(old))]
        self._spawned = max(self._spawned, len(old))
        for req in pending:
            self._resubmit(req)
        return True

    # ------------------------------------------------------------ controller --
    def apply_decision(self, decision, *, controller=None,
                       engines_per_gpu: Optional[int] = None) -> bool:
        """Apply an already-made controller serving decision: scale the
        worker set to ``serving_gpus * engines_per_gpu`` engines and/or
        rebuild them at the decided slot width.  This is the router's
        ONLY mutation hook on the control plane — the decision itself is
        Algorithm 2's, made wherever the single controller instance runs
        (normally the overlapped ``AsyncRunner`` round loop).

        Two guards close the double-replan hazard:

        * **staleness** — a decision captured before an ``AsyncRunner``
          re-plan drained carries the pre-drain ``seq``; the re-plan
          bumps ``controller.plan_seq``, so such a decision is refused
          (and the controller's committed split reconciled to the real
          fleet) instead of applying a split computed against a layout
          that no longer exists;
        * **single application** — a decision object applies at most
          once, so the runner-driven path and a direct
          :meth:`maybe_replan` caller can never both act on one epoch.

        Returns True when the worker set changed."""
        if decision is None or not decision.layout_changed:
            return False
        if engines_per_gpu is None:
            engines_per_gpu = max(int(getattr(controller,
                                              "gmi_per_gpu", 1)), 1)
        achieved = max(self.num_engines // engines_per_gpu, 1)
        if controller is not None:
            seq = getattr(decision, "seq", None)
            plan_seq = getattr(controller, "plan_seq", None)
            if None not in (seq, plan_seq) and seq != plan_seq:
                self.stale_decisions += 1
                if achieved != controller.serving_gpus:
                    controller.serving_gpus = achieved
                return False
            if decision is self._last_applied:
                return False
            self._last_applied = decision
        changed = False
        if decision.slots:
            changed = self.resize_slots(decision.slots) or changed
        before = self.num_engines
        self.scale_to(decision.serving_gpus * engines_per_gpu)
        # reconcile: a router that COULD not follow (no factory, fixed
        # engine list) must not let the controller's committed split
        # drift from the real fleet — its telemetry divisor would shrink
        # per-instance throughput a little more every unapplied epoch
        if controller is not None:
            achieved = max(self.num_engines // engines_per_gpu, 1)
            if achieved != controller.serving_gpus:
                controller.serving_gpus = achieved
        return changed or self.num_engines != before

    def maybe_replan(self, controller, *,
                     engines_per_gpu: Optional[int] = None) -> bool:
        """Fold one telemetry epoch into the controller's serving loop and
        apply whatever Algorithm 2 answers — a thin
        observe-then-:meth:`apply_decision` wrapper kept for standalone
        serving (no runner).  ``engines_per_gpu`` defaults to the
        controller's ``gmi_per_gpu`` so the engine count matches the
        instance count the controller divides telemetry by — a mismatch
        would mis-key its measured slot table.  Returns True when the
        worker set changed."""
        decision = controller.observe_serving(self.take_epoch())
        return self.apply_decision(decision, controller=controller,
                                   engines_per_gpu=engines_per_gpu)


class ServingRole(DRLRole):
    """Paper Listing 1's serving instance, made concrete: a GMI whose
    execution routine is the continuous-batching engine loop.

    Registers the GMI with the manager, carves its resource slice, and —
    under the ``submesh`` backend — builds the engine on the instance's
    own context (its share of the manager's card's SMs and a stream on
    them), so its
    work is ordered apart from every other instance's.  Otherwise the
    engine runs on the manager's card, on the current stream."""

    def __init__(self, manager: GMIManager, gmi_id: int, gpu_id: int,
                 cfg, params, *, resource_fraction: float = 1.0,
                 max_slots: int = 4, max_seq: int = 128,
                 window_override: Optional[int] = None):
        super().__init__(manager, gmi_id, "serving", gpu_id,
                         resource_fraction)
        gmi = manager.submesh(gmi_id) \
            if manager.backend == "submesh" else None
        self.engine = ServeEngine(cfg, params, max_slots=max_slots,
                                  max_seq=max_seq,
                                  window_override=window_override,
                                  device=manager.device, gmi=gmi,
                                  name=f"gmi{gmi_id}")

    def gmi_run(self, requests: List[Request]) -> List[Completion]:
        """The GMI's execution routine: serve a batch of requests to
        completion inside this instance's slice."""
        return self.engine.serve(requests)
