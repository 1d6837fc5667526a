"""Prefill/decode disaggregation across GMIs (JigsawRL arXiv:2604.23838's
request-level scheduling argument applied to the GMI-DRL serving pool);
port of ``repro/serve/disagg.py``.

Aggregated serving runs every request's whole-prompt B=1 prefill on the
decode GMI that will host it, stalling that engine's decode batch for
the prefill duration.  Disaggregated serving splits the roles:

* :class:`PrefillEngine` — a prefill-specialist GMI.  Runs the SAME
  ``transformer.prefill`` + token pick the decode engines use (identical
  cfg/params/max_seq/window; on the card every attention layer through
  the flash kernel), so the cache and first token it produces equal what
  the decode engine would have computed in a B=1 whole-prompt prefill of
  its own (in f32; a decode engine's batched prefill of several prompts
  rounds differently in bf16).  Its product is a :class:`CachePayload`.
* :class:`~repro_torch.core.channels.CacheChannel` — the migration link: the
  payload's cache pytree is packed into per-dtype contiguous buffers
  (``kernels.channel_pack.pack_cache_payload`` — one coarse move, the
  §4.2 anti-fine-grained-transfer discipline) and reassembled bit-exact
  on the decode side, with (seconds, bytes) samples feeding the same
  bandwidth calibrator as gradient reduces.
* :class:`MigrationPlanner` — per-request migrate-vs-local decision in
  Table-2 units (``core.cost_model.migration_beats_local``): migration
  costs ``latency + bytes/bandwidth`` against the measured local-prefill
  stall ``prompt_tokens / prefill_tok_s``, under the controller's own
  1.05x hysteresis.  Bandwidth preference order: measured channel
  samples (EMA) > the communicator's calibrated Table-2 fit > static
  default.  Short prompts stay local; long prompts migrate.
* :class:`DisaggFront` — the composed serving front.  Request lifecycle::

      submit -> planner: migrate or local?
        local   -> RequestRouter -> decode GMI [B=1 prefill + splice]
        migrate -> prefill GMI -> CachePayload -> CacheChannel
                -> decode GMI ``submit_prefilled`` [splice only]
      -> batched decode -> completion

Streams: each engine may run on its own GMI (``gmi=``, a CUDA stream).
A prefill GMI prefills and packs on its stream; the front hands each
delivered payload to its destination decode GMI's stream (the channel
makes that stream wait for the pack), and the decode GMI splices it
there.

Control plane: the front does NOT make scaling decisions.  It exposes
``take_epoch`` (router load + prefill telemetry: ``prefill_backlog``,
``migrations``) and ``apply_decision`` (resize the prefill set from
``Decision.prefill_gpus``, then delegate to the router), and the single
:class:`~repro_torch.core.controller.OnlineGMIController` instance driven by
``AsyncRunner.round`` arbitrates trainers, rollout actors, prefill GMIs,
and decode GMIs together.

Fault story (extends the serving front's zero-request-loss invariant): a dead prefill
GMI forfeits its queued prompts and its still-staged channel transfers
(``CacheChannel.fail_source``); :meth:`DisaggFront.fail_prefill_engine`
re-prefills all of them on surviving prefill GMIs — or re-routes them to
the decode side's local-prefill path when no specialist survives.  Every
request completes either way.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channels import CacheChannel
from repro_torch.core.cost_model import migration_beats_local
from repro_torch.kernels.channel_pack import truncate_cache_pages
from repro_torch.models import transformer as T
from repro_torch.serve.engine import (Completion, Request, ServeEngine,
                                      _pick_tokens)
from repro_torch.serve.router import RequestRouter
from repro_torch.serve.telemetry import ServingLoad
from repro_torch.utils import resolve_device, tree_map


@dataclass
class CachePayload:
    """A finished prefill, portable between GMIs: the cache tree (batch
    dim 1 at axis 1 on every stacked leaf — the shape ``ServeEngine``'s
    splice expects), the first generated token, and the request's
    original latency clock.

    For a paged decode destination the front prunes the tree to whole
    pages (``kernels.channel_pack.truncate_cache_pages``) before it hits
    the wire; ``head_pages`` > 0 additionally records that the leading
    prompt pages were STRIPPED because the chosen destination already
    holds them in its shared-prefix index — the payload is then only
    splice-complete on an engine that still has those pages (any other
    engine falls back to a full local prefill, losslessly)."""
    req: Request
    cache: Any
    first_id: int
    prompt_tokens: int
    submit_t: float = 0.0
    prefill_s: float = 0.0
    head_pages: int = 0


class PrefillEngine:
    """Prefill-specialist GMI: whole-prompt B=1 prefill, no decode slots.

    Shares cfg/params/max_seq/window with the decode engines it feeds —
    the token-identity precondition.  One :meth:`step` prefills one
    queued request and returns its :class:`CachePayload` (or None when
    idle).  Carries the same fault seam as ``ServeEngine.step``: a
    ``fault_hook`` raising marks the engine dead and tags the exception
    with the corpse for the supervisor.

    ``device`` (default ``"cuda"``) and ``gmi`` (a ``GMIContext``) take
    the reference's ``mesh``, as in ``ServeEngine``: the prefill and the
    first-token readback run under the GMI's stream.  Params already on
    the device in ``cfg.dtype`` are shared, not copied.
    ``prefill_dispatches`` counts whole-prompt prefills (each runs the
    flash kernel once an attention layer on the card)."""

    def __init__(self, cfg: ModelConfig, params, *, max_seq: int = 128,
                 window_override: Optional[int] = None, device="cuda",
                 gmi=None, name: str = "prefill"):
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.name}: encoder-only model has no "
                             "decode step — nothing to prefill for")
        self.cfg = cfg
        self.max_seq = int(max_seq)
        self.window_override = window_override
        self.name = name
        self.fault_hook = None
        self.dead = False
        self.gmi = gmi
        self.device = resolve_device(gmi.device if gmi is not None
                                     else device)
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self.scope():
            self.params = T.cast_params(
                tree_map(lambda t: t.to(self.device), params), cfg)
        self._queue: List[Request] = []
        self._submit_t = {}
        # epoch-scoped prefill telemetry (folded into the front's load)
        self._epoch_prefill_s = 0.0
        self._epoch_prefilled = 0
        self._epoch_prefill_tokens = 0
        self.total_prefilled = 0
        self.prefill_dispatches = 0

    @property
    def stream(self):
        """The GMI's CUDA stream, or None (current stream, or the CPU)."""
        return self.gmi.stream if self.gmi is not None else None

    def scope(self):
        """A context manager that enters the GMI's context: its green
        context and stream on the card (``GMIContext.scope``)."""
        return contextlib.nullcontext() if self.gmi is None \
            else self.gmi.scope()

    @property
    def load(self) -> int:
        return len(self._queue)

    @property
    def busy(self) -> bool:
        return self.load > 0

    def submit(self, req: Request, submit_t: Optional[float] = None) -> int:
        total = len(req.tokens) + req.max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt+budget {total} exceeds "
                f"prefill max_seq {self.max_seq}")
        self._submit_t.setdefault(
            req.rid, time.perf_counter() if submit_t is None else submit_t)
        self._queue.append(req)
        return req.rid

    def take_queue(self) -> List[Request]:
        """Remove every queued request (failover: a survivor re-prefills
        them; latency clocks ride on ``req._submit_t``)."""
        out, self._queue = self._queue, []
        for r in out:
            r._submit_t = self._submit_t.pop(r.rid, None)
        return out

    def step(self) -> Optional[CachePayload]:
        """Prefill the oldest queued request into a portable payload."""
        if self.fault_hook is not None:
            try:
                self.fault_hook(self)
            except Exception as exc:
                self.dead = True
                if getattr(exc, "engine", None) is None:
                    exc.engine = self
                raise
        if self.dead:
            raise RuntimeError(f"{self.name}: prefill engine is dead")
        if not self._queue:
            return None
        req = self._queue.pop(0)
        t0 = time.perf_counter()
        with self.scope():
            batch = {"tokens": torch.as_tensor(req.tokens[None],
                                               device=self.device)}
            for k, v in (req.extras or {}).items():
                batch[k] = torch.as_tensor(np.asarray(v)[None],
                                           device=self.device)
            logits, cache = T.prefill(self.params, self.cfg, batch,
                                      self.max_seq, self.window_override)
            self.prefill_dispatches += 1
            prompt_tokens = len(req.tokens)
            first = _pick_tokens(logits,
                                 np.asarray([prompt_tokens - 1], np.int32),
                                 np.asarray([req.seed], np.int32),
                                 np.asarray([req.temperature], np.float32))
            # the one host sync a prefill: this GMI's stream only
            first_id = int(first[0])
        prefill_s = time.perf_counter() - t0
        self._epoch_prefill_s += prefill_s
        self._epoch_prefilled += 1
        self._epoch_prefill_tokens += prompt_tokens
        self.total_prefilled += 1
        return CachePayload(
            req=req, cache=cache, first_id=first_id,
            prompt_tokens=prompt_tokens,
            submit_t=self._submit_t.pop(req.rid, t0),
            prefill_s=prefill_s)

    def take_epoch(self) -> tuple:
        """(prefill seconds, prompts, prompt tokens) this epoch; resets."""
        out = (self._epoch_prefill_s, self._epoch_prefilled,
               self._epoch_prefill_tokens)
        self._epoch_prefill_s = 0.0
        self._epoch_prefilled = 0
        self._epoch_prefill_tokens = 0
        return out


class MigrationPlanner:
    """Per-request migrate-vs-local decision in Table-2 cost-model units.

    Seeds with static defaults, then follows measurements: channel
    (seconds, bytes) samples sharpen the bandwidth estimate (EMA), the
    decode engines' measured prefill throughput sharpens the local-stall
    estimate, and an attached communicator's calibrated Table-2 fit
    supplies bandwidth while the channel is still unmeasured."""

    def __init__(self, *, bandwidth: Optional[float] = None,
                 communicator=None, latency_s: float = 100e-6,
                 min_gain: float = 1.05,
                 prefill_tok_s: float = 2e3, ema: float = 0.3):
        self.communicator = communicator
        self.static_bandwidth = bandwidth
        self.latency_s = float(latency_s)
        self.min_gain = float(min_gain)
        self._prefill_tok_s = float(prefill_tok_s)
        self._bw_measured: Optional[float] = None
        self.ema = float(ema)
        self.migrated = 0
        self.kept_local = 0

    @property
    def bandwidth(self) -> float:
        if self._bw_measured is not None:
            return self._bw_measured
        if self.static_bandwidth is not None:
            return self.static_bandwidth
        if self.communicator is not None:
            cm = self.communicator.effective_cost_model
            if callable(cm):        # property on Communicator, fn on fakes
                cm = cm()
            return float(cm.bw_gpu)     # B2: the cross-GPU interconnect
        return 5e9

    @property
    def prefill_tok_s(self) -> float:
        return self._prefill_tok_s

    def observe_transfer(self, seconds: float, nbytes: int) -> None:
        if seconds <= 0.0 or nbytes <= 0:
            return
        bw = nbytes / seconds
        self._bw_measured = bw if self._bw_measured is None else \
            (1 - self.ema) * self._bw_measured + self.ema * bw
        if self.communicator is not None:
            # migration timings are channel-transfer evidence for the
            # same Table-2 calibration that prices gradient reduces
            self.communicator.observe_transfer(seconds, nbytes)

    def observe_prefill(self, tokens: int, seconds: float) -> None:
        if seconds <= 0.0 or tokens <= 0:
            return
        rate = tokens / seconds
        self._prefill_tok_s = \
            (1 - self.ema) * self._prefill_tok_s + self.ema * rate

    def should_migrate(self, nbytes: float, prompt_tokens: int) -> bool:
        take = migration_beats_local(
            nbytes, prompt_tokens, self.bandwidth, self._prefill_tok_s,
            self.latency_s, self.min_gain)
        if take:
            self.migrated += 1
        else:
            self.kept_local += 1
        return take


class DisaggFront:
    """The disaggregated serving front: prefill specialists + a decode
    :class:`RequestRouter`, joined by a :class:`CacheChannel`, with the
    :class:`MigrationPlanner` choosing per request.

    Duck-types the router surface the control plane consumes (``submit``
    / ``step`` / ``drain`` / ``take_epoch`` / ``apply_decision`` /
    ``busy`` / ``completions``), so ``AsyncRunner`` and the
    ``FleetSupervisor`` drive aggregated and disaggregated fleets through
    one code path."""

    def __init__(self, router: RequestRouter,
                 prefill_engines: List[PrefillEngine], *,
                 channel: Optional[CacheChannel] = None,
                 planner: Optional[MigrationPlanner] = None,
                 prefill_factory: Optional[
                     Callable[[int], PrefillEngine]] = None):
        if not prefill_engines and prefill_factory is None:
            raise ValueError("need prefill engines or a prefill_factory")
        self.router = router
        self.prefill_engines = list(prefill_engines)
        self._prefill_factory = prefill_factory
        self._spawned = len(self.prefill_engines)
        if not self.prefill_engines:
            self.prefill_engines = [prefill_factory(0)]
            self._spawned = 1
        self.channel = channel or CacheChannel()
        self.planner = planner or MigrationPlanner()
        # per-slot payload wire size, measured off the first migration;
        # estimated from the decode engines' cache footprint until then
        self._payload_bytes: Optional[float] = None
        # measured wire bytes per page (paged decode engines), for the
        # planner's per-request page pricing
        self._page_bytes: Optional[float] = None
        self._epoch_migrations = 0
        # cumulative pages NOT shipped thanks to shared-prefix dedup
        self.prefix_pages_saved = 0
        self.failed_prefill_engines = 0

    # ------------------------------------------------------------ routing --
    @property
    def engines(self) -> List[ServeEngine]:
        return self.router.engines

    @property
    def num_engines(self) -> int:
        return self.router.num_engines

    @property
    def completions(self) -> List[Completion]:
        return self.router.completions

    @property
    def busy(self) -> bool:
        return (any(e.busy for e in self.prefill_engines)
                or self.channel.in_flight > 0 or self.router.busy)

    @property
    def payload_bytes(self) -> float:
        if self._payload_bytes is not None:
            return self._payload_bytes
        eng = self.router.engines[0]
        return eng.cache_bytes / max(eng.max_slots, 1)

    def request_bytes(self, prompt_tokens: int) -> float:
        """Estimated wire bytes for THIS prompt's payload.  Paged decode
        engines ship ceil(prompt/page) pages, so the estimate scales with
        the prompt instead of charging every request the full per-slot
        footprint (which made short prompts look costlier to migrate than
        they are)."""
        eng = self.router.engines[0]
        P = int(getattr(eng, "page_size", 0) or 0)
        if not getattr(eng, "paged", False) or P <= 0:
            return self.payload_bytes
        pages = -(-max(int(prompt_tokens), 1) // P)
        if self._page_bytes is not None:
            return self._page_bytes * pages
        # pro-rate the per-slot estimate by prompt coverage until measured
        total = max(getattr(eng, "pages_per_slot", 1), 1)
        return self.payload_bytes * min(pages / total, 1.0)

    def submit(self, req: Request) -> int:
        """Route one request: the planner prices shipping its finished
        cache (page-wise for paged decode engines) against stalling a
        decode batch on local prefill."""
        if self.prefill_engines and self.planner.should_migrate(
                self.request_bytes(len(req.tokens)), len(req.tokens)):
            eng = min(self.prefill_engines, key=lambda e: e.load)
            return eng.submit(req)
        return self.router.submit(req)

    # ------------------------------------------------------------ stepping --
    def _stage_payload(self, payload: CachePayload):
        """Pick the payload's decode destination NOW (least-loaded), prune
        the cache to whole pages for it, and strip the leading pages its
        shared-prefix index already holds.  Returns (wire tree, dst)."""
        dst = min(self.router.engines, key=lambda e: e.load)
        cache = payload.cache
        P = int(getattr(dst, "page_size", 0) or 0)
        if getattr(dst, "paged", False) and P > 0:
            head = 0
            if not payload.req.extras \
                    and hasattr(dst, "shared_head_pages"):
                head = int(dst.shared_head_pages(payload.req.tokens))
            cache = truncate_cache_pages(cache, payload.prompt_tokens, P,
                                         head_skip=head)
            payload.head_pages = head
            self.prefix_pages_saved += head
        payload._dst = dst
        return cache, dst

    def _consumer(self):
        """The channel's ``deliver(stream=)`` callable for one tick: it
        settles each delivered payload's decode engine (the staged choice,
        or, when that engine retired or died mid-flight, the least-loaded
        survivor, counting the payloads settled before it in this tick as
        the reference's submit-as-you-go loop does) and returns that
        engine's stream, which the channel makes ready."""
        pending = {}

        def consumer(payload):
            dst = getattr(payload, "_dst", None)
            if dst is None or dst not in self.router.engines:
                dst = min(self.router.engines,
                          key=lambda e: e.load + pending.get(id(e), 0))
                payload._dst = dst
            pending[id(dst)] = pending.get(id(dst), 0) + 1
            payload._ready_on = getattr(dst, "stream", None)
            return payload._ready_on

        return consumer

    def step(self) -> List[Completion]:
        """One front tick: each prefill GMI prefills one prompt into the
        channel, the channel delivers finished payloads to their chosen
        decode GMIs, and every busy decode engine takes one batched
        decode step."""
        for eng in self.prefill_engines:
            if not eng.busy:
                continue
            payload = eng.step()
            if payload is not None:
                cache, dst = self._stage_payload(payload)
                # the pack runs on the prefill GMI's stream, after its
                # prefill
                scope = getattr(eng, "scope", contextlib.nullcontext)
                with scope():
                    nbytes = float(self.channel.send(payload, cache,
                                                     source=eng))
                self._payload_bytes = nbytes
                P = int(getattr(dst, "page_size", 0) or 0)
                if getattr(dst, "paged", False) and P > 0:
                    shipped = max(
                        -(-payload.prompt_tokens // P) - payload.head_pages,
                        1)
                    self._page_bytes = nbytes / shipped
        for payload, cache in self.channel.deliver(stream=self._consumer()):
            payload.cache = cache      # the reassembled, bit-exact tree
            # a payload whose chosen engine retired or died mid-flight
            # went to a survivor (``_consumer``); a head-stripped payload
            # that lands on an engine missing the prefix re-queues for a
            # full local prefill there (ServeEngine.prefix_fallbacks),
            # lossless
            payload._dst.submit_prefilled(payload)
            self._epoch_migrations += 1
        for sec, nbytes in self.channel.take_transfer_samples():
            self.planner.observe_transfer(sec, nbytes)
        return self.router.step()

    def drain(self) -> List[Completion]:
        done: List[Completion] = []
        while self.busy:
            done.extend(self.step())
        return done

    def serve(self, requests: List[Request]) -> List[Completion]:
        for r in requests:
            self.submit(r)
        return self.drain()

    # ----------------------------------------------------------- telemetry --
    def take_epoch(self) -> ServingLoad:
        """Router-level load with the disagg extensions: decode-side
        measured prefill throughput feeds the planner, prefill-side work
        folds into ``prefill_s``, and ``prefill_backlog``/``migrations``
        carry the signals the controller's prefill arbitration reads."""
        load = self.router.take_epoch()
        pf_s = 0.0
        for eng in self.prefill_engines:
            s, _, ptoks = eng.take_epoch()
            pf_s += s
            if s > 0.0 and ptoks > 0:
                # measured prompt-tokens/s off the specialists — the same
                # compiled prefill the decode engines run, so this IS the
                # planner's local-stall rate
                self.planner.observe_prefill(ptoks, s)
        backlog = sum(e.load for e in self.prefill_engines) \
            + self.channel.in_flight
        migrations, self._epoch_migrations = self._epoch_migrations, 0
        return ServingLoad(
            dt=max(load.dt, pf_s), tokens=load.tokens,
            requests=load.requests,
            queue_depth_mean=load.queue_depth_mean,
            queue_depth_max=load.queue_depth_max,
            occupancy_mean=load.occupancy_mean, backlog=load.backlog,
            p50_s=load.p50_s, p95_s=load.p95_s, slots=load.slots,
            prefill_s=load.prefill_s + pf_s, decode_s=load.decode_s,
            mem_bytes=load.mem_bytes,
            prefill_backlog=backlog, migrations=migrations,
            free_pages=load.free_pages, total_pages=load.total_pages)

    # ------------------------------------------------------- control plane --
    def apply_decision(self, decision, *, controller=None,
                       engines_per_gpu: Optional[int] = None) -> bool:
        """The front's thin apply hook: resize the prefill-specialist set
        from ``Decision.prefill_gpus`` (same ``engines_per_gpu``
        granularity as the decode side), then delegate the decode-side
        split/slots to :meth:`RequestRouter.apply_decision` — which owns
        the staleness and single-application guards."""
        if decision is None or not decision.layout_changed:
            return False
        if engines_per_gpu is None:
            engines_per_gpu = max(int(getattr(controller,
                                              "gmi_per_gpu", 1)), 1)
        changed = self.router.apply_decision(
            decision, controller=controller,
            engines_per_gpu=engines_per_gpu)
        want = getattr(decision, "prefill_gpus", None)
        # the router's guards decide acceptance: a stale or already-
        # applied decision must not move the prefill set either
        accepted = controller is None \
            or decision is self.router._last_applied
        if want is not None and accepted:
            # a front always keeps >= 1 specialist: prefill_gpus == 0
            # means the controller wants pure local prefill, which the
            # planner implements per-request; one engine stays warm
            n = max(int(want) * engines_per_gpu, 1)
            changed = self._scale_prefill(n) or changed
            if controller is not None and want > 0:
                # reconcile a front that could not follow (no factory)
                achieved = max(len(self.prefill_engines)
                               // engines_per_gpu, 1)
                if achieved != controller.prefill_gpus:
                    controller.prefill_gpus = achieved
        return changed

    def maybe_replan(self, controller, *,
                     engines_per_gpu: Optional[int] = None) -> bool:
        """Standalone observe-then-apply (no runner); the runner-driven
        path calls ``observe_serving`` + :meth:`apply_decision` itself."""
        decision = controller.observe_serving(self.take_epoch())
        return self.apply_decision(decision, controller=controller,
                                   engines_per_gpu=engines_per_gpu)

    def _scale_prefill(self, n: int) -> bool:
        n = max(int(n), 1)
        before = len(self.prefill_engines)
        while len(self.prefill_engines) < n:
            if self._prefill_factory is None:
                break
            self.prefill_engines.append(
                self._prefill_factory(self._spawned))
            self._spawned += 1
        while len(self.prefill_engines) > n:
            retiree = self.prefill_engines.pop()
            for req in retiree.take_queue():
                self._requeue(req)
        return len(self.prefill_engines) != before

    # ---------------------------------------------------------------- fault --
    def fail_engine(self, engine: ServeEngine,
                    max_retries: int = 2) -> List[Completion]:
        """Remove a DEAD decode engine: the router's lossless failover
        (``RequestRouter.fail_engine``).  The reference's front lacks this
        and ``num_engines``, so its supervisor cannot fail a decode engine
        over behind a disaggregated front (ROADMAP C11); the port
        delegates both to the router."""
        return self.router.fail_engine(engine, max_retries)

    def _requeue(self, req: Request) -> None:
        """Re-route a request whose prefill never finished: a surviving
        specialist re-prefills it, or it falls back to the decode side's
        local-prefill path.  Latency clocks ride ``req._submit_t``."""
        if self.prefill_engines:
            eng = min(self.prefill_engines, key=lambda e: e.load)
            eng.submit(req, submit_t=getattr(req, "_submit_t", None))
        else:
            self.router._resubmit(req)

    def fail_prefill_engine(self, engine: PrefillEngine) -> int:
        """Remove a DEAD prefill specialist losslessly: its queued
        prompts re-route (:meth:`_requeue`) and its in-flight cache
        transfers — payloads staged in the channel whose device buffers
        died with the source — are re-prefilled from the original
        request.  Zero requests lost, extending the decode side's invariant to the
        prefill role.  Returns the number of re-routed requests."""
        if engine not in self.prefill_engines:
            return 0
        self.prefill_engines.remove(engine)
        self.failed_prefill_engines += 1
        queued = engine.take_queue()
        lost = self.channel.fail_source(engine)
        if not self.prefill_engines and self._prefill_factory is not None:
            self.prefill_engines.append(self._prefill_factory(self._spawned))
            self._spawned += 1
        for req in queued:
            self._requeue(req)
        for payload in lost:
            req = payload.req
            req._submit_t = payload.submit_t
            self._requeue(req)
        return len(queued) + len(lost)
