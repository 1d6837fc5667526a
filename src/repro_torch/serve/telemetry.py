"""Serving telemetry — the measurement side of adaptive GMI management
(a copy of ``repro/serve/telemetry.py``: numpy only, so the port keeps
its own copy rather than importing the JAX package).

arXiv:2012.04210's argument (already driving the rollout controller) is
that the serving:training split must follow *measured* load — which
requires serving to produce telemetry in the first place.  This module is
that producer: every :class:`~repro_torch.serve.engine.ServeEngine` owns a
:class:`ServingTelemetry`, records each admission, decode step, and
completion into it, and the router / controller consume epoch snapshots
(:class:`ServingLoad`) the same way the rollout loop consumes
``RoundSample``s.

Nothing here imports the engine or the controller — the coupling is one
dataclass (:class:`ServingLoad`) that the controller duck-types.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class ServingLoad:
    """One telemetry epoch of a serving instance (or an aggregate of
    several) — the serving analogue of the controller's ``RoundSample``."""
    dt: float                   # wall seconds spanned by the epoch
    tokens: int                 # tokens generated (prefill first-token incl.)
    requests: int               # requests completed during the epoch
    queue_depth_mean: float     # mean waiting requests over decode steps
    queue_depth_max: int        # peak waiting requests
    occupancy_mean: float       # mean busy-slot fraction over decode steps
    backlog: int                # requests still waiting at epoch end with
                                # every decode slot busy (admission-starved)
    p50_s: float                # median completed-request latency (seconds)
    p95_s: float                # tail completed-request latency (seconds)
    slots: int                  # decode slots of the producing engine(s)
    prefill_s: float = 0.0      # wall seconds spent in prefill
    decode_s: float = 0.0       # wall seconds spent in decode steps
    mem_bytes: float = 0.0      # cache bytes held (memory-pressure proxy)
    # disaggregated-serving extensions (trailing defaults: ServingLoad is
    # constructed positionally in several places)
    prefill_backlog: int = 0    # requests waiting on a prefill GMI at
                                # epoch end (the prefill-pressure signal)
    migrations: int = 0         # cache payloads migrated prefill->decode
    # paged-cache extensions: free/total pages of the engine's page pool
    # (0/0 for dense engines).  Page occupancy already feeds
    # ``occupancy_mean`` indirectly — admission blocks on free pages — so
    # the controller's ladder logic needs no change; these are the raw
    # counters for benches and capacity planning.
    free_pages: int = 0
    total_pages: int = 0

    @property
    def tok_s(self) -> float:
        return self.tokens / self.dt if self.dt > 0 else 0.0


def merge_loads(loads: List[ServingLoad],
                live_slots: Optional[int] = None) -> ServingLoad:
    """Aggregate per-engine epochs into one router-level load.  Engines run
    concurrently, so ``dt`` is the max span (not the sum) while counters
    add; occupancy/queue means weight by slots.  ``live_slots`` overrides
    the reported slot capacity — when the list mixes retired engines'
    final epochs with their replacements', summing both sides would
    report phantom capacity the consumer (the controller's slot-table
    keying) would mis-divide by."""
    if not loads:
        return ServingLoad(0.0, 0, 0, 0.0, 0, 0.0, 0, 0.0, 0.0,
                           live_slots or 0)
    tot_slots = sum(l.slots for l in loads) or 1
    # percentile summaries don't compose exactly; approximate the merged
    # p50 as the request-weighted mean of engine medians and keep the
    # WORST engine tail as the merged p95 (never hides a slow engine,
    # unlike reconstructing a population — which collapses p95 to p50 for
    # engines with few completions)
    served = [l for l in loads if l.requests > 0]
    n_req = sum(l.requests for l in served)
    p50 = sum(l.p50_s * l.requests for l in served) / n_req if n_req else 0.0
    p95 = max((l.p95_s for l in served), default=0.0)
    return ServingLoad(
        dt=max(l.dt for l in loads),
        tokens=sum(l.tokens for l in loads),
        requests=sum(l.requests for l in loads),
        queue_depth_mean=sum(l.queue_depth_mean for l in loads),
        queue_depth_max=max(l.queue_depth_max for l in loads),
        occupancy_mean=sum(l.occupancy_mean * l.slots
                           for l in loads) / tot_slots,
        backlog=sum(l.backlog for l in loads),
        p50_s=p50, p95_s=p95,
        slots=live_slots if live_slots is not None else tot_slots,
        prefill_s=sum(l.prefill_s for l in loads),
        decode_s=sum(l.decode_s for l in loads),
        mem_bytes=sum(l.mem_bytes for l in loads),
        prefill_backlog=sum(l.prefill_backlog for l in loads),
        migrations=sum(l.migrations for l in loads),
        free_pages=sum(l.free_pages for l in loads),
        total_pages=sum(l.total_pages for l in loads))


class ServingTelemetry:
    """Per-engine measurement sink.

    The engine calls ``on_submit`` / ``on_admit`` / ``on_step`` /
    ``on_finish``; :meth:`take_epoch` folds everything since the last call
    into one :class:`ServingLoad` and resets the epoch counters (cumulative
    totals survive — the CLI summaries read those)."""

    def __init__(self, slots: int, clock=time.perf_counter):
        self.slots = int(slots)
        self.clock = clock
        # epoch-scoped
        self._steps: List[Tuple[float, int, int]] = []   # (dt, active, queued)
        self._latencies: List[float] = []
        self._epoch_tokens = 0
        self._epoch_requests = 0
        self._epoch_prefill_s = 0.0
        self._epoch_decode_s = 0.0
        self._epoch_start: Optional[float] = None
        self._epoch_last: Optional[float] = None
        self._end_active = 0
        self._end_queued = 0
        # request-lifetime
        self._submit_t: Dict[int, float] = {}
        # cumulative
        self.total_tokens = 0
        self.total_prompt_tokens = 0
        self.total_requests = 0
        self.total_prefill_s = 0.0
        self.total_decode_s = 0.0
        self.total_decode_steps = 0

    # ------------------------------------------------------------- events --
    def _mark(self, t: float):
        if self._epoch_start is None:
            self._epoch_start = t
        self._epoch_last = t

    def on_submit(self, rid: int, t: Optional[float] = None):
        # an explicit t only backdates the LATENCY clock (re-routed
        # requests keep their original arrival); epoch span markers always
        # move with the wall clock, or a re-route just after an epoch
        # reset would rewind the epoch start and inflate its dt
        now = self.clock()
        self._submit_t.setdefault(rid, now if t is None else t)
        self._mark(now)

    def on_admit(self, rid: int, prompt_tokens: int, prefill_s: float,
                 t: Optional[float] = None):
        t = self.clock() if t is None else t
        self._submit_t.setdefault(rid, t - prefill_s)
        self._epoch_prefill_s += prefill_s
        self._epoch_tokens += 1          # prefill emits the first token
        self.total_prefill_s += prefill_s
        self.total_prompt_tokens += prompt_tokens
        self.total_tokens += 1
        self._mark(t)

    def on_step(self, dt: float, active: int, queued: int, tokens_out: int,
                t: Optional[float] = None):
        t = self.clock() if t is None else t
        self._steps.append((dt, active, queued))
        self._epoch_decode_s += dt
        self._epoch_tokens += tokens_out
        self._end_active, self._end_queued = active, queued
        self.total_decode_s += dt
        self.total_decode_steps += 1
        self.total_tokens += tokens_out
        self._mark(t)

    def on_finish(self, rid: int, t: Optional[float] = None):
        t = self.clock() if t is None else t
        t0 = self._submit_t.pop(rid, None)
        if t0 is not None:
            self._latencies.append(t - t0)
        self._epoch_requests += 1
        self.total_requests += 1
        self._mark(t)

    def submit_time(self, rid: int, default: float = 0.0) -> float:
        return self._submit_t.get(rid, default)

    # -------------------------------------------------------------- epoch --
    def percentiles(self) -> Tuple[float, float]:
        """(p50, p95) completed-request latency of the current epoch."""
        if not self._latencies:
            return 0.0, 0.0
        arr = np.asarray(self._latencies)
        return float(np.percentile(arr, 50)), float(np.percentile(arr, 95))

    def snapshot(self, mem_bytes: float = 0.0, free_pages: int = 0,
                 total_pages: int = 0) -> ServingLoad:
        """The current epoch as a :class:`ServingLoad` (no reset)."""
        p50, p95 = self.percentiles()
        if self._steps:
            q_mean = sum(q for _, _, q in self._steps) / len(self._steps)
            q_max = max(q for _, _, q in self._steps)
            occ = sum(a for _, a, _ in self._steps) / (
                len(self._steps) * max(self.slots, 1))
        else:
            q_mean, q_max, occ = 0.0, 0, 0.0
        span = 0.0
        if self._epoch_start is not None and self._epoch_last is not None:
            span = self._epoch_last - self._epoch_start
        dt = max(span, self._epoch_prefill_s + self._epoch_decode_s)
        backlog = self._end_queued if self._end_active >= self.slots else 0
        return ServingLoad(
            dt=dt, tokens=self._epoch_tokens, requests=self._epoch_requests,
            queue_depth_mean=q_mean, queue_depth_max=int(q_max),
            occupancy_mean=occ, backlog=int(backlog),
            p50_s=p50, p95_s=p95, slots=self.slots,
            prefill_s=self._epoch_prefill_s, decode_s=self._epoch_decode_s,
            mem_bytes=mem_bytes, free_pages=int(free_pages),
            total_pages=int(total_pages))

    def take_epoch(self, mem_bytes: float = 0.0, free_pages: int = 0,
                   total_pages: int = 0) -> ServingLoad:
        """Snapshot the epoch and reset its counters (cumulative totals and
        in-flight submit timestamps survive)."""
        load = self.snapshot(mem_bytes, free_pages, total_pages)
        self._steps = []
        self._latencies = []
        self._epoch_tokens = 0
        self._epoch_requests = 0
        self._epoch_prefill_s = 0.0
        self._epoch_decode_s = 0.0
        self._epoch_start = None
        self._epoch_last = None
        self._end_active = 0
        self._end_queued = 0
        return load
