"""Deterministic fault injection — the reproducible half of the fault
subsystem; port of ``repro/fault/inject.py``.

A :class:`FaultPlan` is a seeded, pre-computed schedule of
:class:`FaultEvent`\\ s.  Hooks installed by the
:class:`~repro_torch.fault.supervisor.FleetSupervisor` consult the plan at
the existing seams (``AsyncRunner.fault_hook``,
``MultiChannelPipeline.fault_hook``, ``checkpoint.save(fault_hook=)``,
the serving engines' and prefill GMIs' ``fault_hook``, and
``CacheChannel.fault_hook``) and
fire each event exactly once at its scheduled round — so a test or
bench replaying the same plan against the same workload sees the exact
same failure sequence AND the exact same recovery sequence.  Nothing in
this module knows how to recover; it only breaks things on schedule.

Fault classes (``KINDS``):

* ``kill_serving``   — a serving GMI dies mid-round, before its push.
* ``kill_trainer``   — a trainer GMI dies mid-round: the batch it was
  consuming (gradient discarded) and everything not yet consumed must be
  re-queued in the ring — spill, not drop.
* ``engine_fail``    — a request-serving engine dies mid-decode: its
  decode slots (cache and all) are gone; queued requests survive at the
  admission front.
* ``prefill_fail``   — a prefill-specialist GMI dies: its queued prompts
  and any cache payload it has in flight on the migration channel must
  re-route to survivors with their latency clocks intact (lossless).
* ``channel_drop``   — a channel flush is lost in transit (the pipeline
  retransmits it on the next flush).
* ``channel_poison`` — a channel flush is delivered corrupted (NaN
  rewards; the trainer-side non-finite guard must discard the update).
* ``ckpt_tear``      — a checkpoint write fails: either a crash mid-save
  (``mode`` naming a :data:`repro_torch.checkpoint.ckpt.SAVE_STAGES`
  stage) or post-hoc corruption of the pair (``mode`` "torn_npz"/"missing_npz",
  applied via :func:`tear_checkpoint`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

KINDS = ("kill_serving", "kill_trainer", "engine_fail", "prefill_fail",
         "channel_drop", "channel_poison", "ckpt_tear")

# ckpt_tear modes: SAVE_STAGES entries crash mid-save (atomicity holds);
# these two post-hoc-corrupt a completed pair (what an unhardened saver
# or external damage produces — the state recovery must SKIP)
TEAR_MODES = ("torn_npz", "missing_npz")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``target`` narrows the victim (a GMI id for
    kill_* events, an engine index for engine_fail); ``None`` matches the
    first candidate the hooks offer — still deterministic, because hook
    call order is the (deterministic) execution order."""
    kind: str
    round: int
    target: Optional[int] = None
    mode: Optional[str] = None        # ckpt_tear only

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")


class InjectedFault(RuntimeError):
    """Raised at an injection seam; carries the event (and, for engine
    faults, the dying engine) so the supervisor can classify and target
    recovery without guessing."""

    def __init__(self, event: FaultEvent, engine=None):
        super().__init__(
            f"injected fault {event.kind} at round {event.round}"
            + (f" (target {event.target})" if event.target is not None
               else ""))
        self.event = event
        self.engine = engine


@dataclass
class FaultPlan:
    """A deterministic schedule of faults.

    ``round`` is advanced by the supervisor; :meth:`take` fires the first
    matching not-yet-fired event whose scheduled round has arrived.  An
    event never fires twice, and an event whose round has passed fires at
    the next opportunity (a kill scheduled for round 3 against a GMI only
    asked about at round 4 still fires — late, but exactly once and at a
    reproducible point)."""
    events: Sequence[FaultEvent] = ()
    seed: int = 0
    round: int = 0
    fired: List[FaultEvent] = field(default_factory=list)

    def __post_init__(self):
        self.events = sorted(
            self.events,
            key=lambda e: (e.round, KINDS.index(e.kind),
                           -1 if e.target is None else e.target))
        self._live: List[FaultEvent] = list(self.events)

    @classmethod
    def random(cls, seed: int, rounds: int,
               kinds: Sequence[str] = ("kill_serving", "kill_trainer",
                                       "engine_fail", "channel_drop"),
               rate: float = 0.25,
               targets: Sequence[int] = (0, 1, 2)) -> "FaultPlan":
        """A seeded random plan: each round draws at most one fault with
        probability ``rate``.  Same seed -> same plan, always."""
        rng = np.random.default_rng(seed)
        events = []
        for r in range(rounds):
            if rng.random() < rate:
                kind = str(rng.choice(list(kinds)))
                target = int(rng.choice(list(targets)))
                events.append(FaultEvent(kind=kind, round=r, target=target))
        return cls(events=events, seed=seed)

    # ------------------------------------------------------------ queries --
    def advance(self, round_index: int) -> None:
        self.round = int(round_index)

    def pending(self, kind: Optional[str] = None) -> List[FaultEvent]:
        return [e for e in self._live if kind is None or e.kind == kind]

    @property
    def exhausted(self) -> bool:
        return not self._live

    def take(self, kind: str, target: Optional[int] = None) \
            -> Optional[FaultEvent]:
        """Fire-once matching: the first live event of ``kind`` whose
        scheduled round has arrived and whose target matches (an event
        with ``target=None`` matches any offered target; an offered
        ``target=None`` matches any event)."""
        for e in self._live:
            if e.kind != kind or e.round > self.round:
                continue
            if e.target is not None and target is not None \
                    and e.target != target:
                continue
            self._live.remove(e)
            self.fired.append(e)
            return e
        return None


# ---------------------------------------------------------- ckpt tearing --
def tear_checkpoint(directory: str, step: int, mode: str = "torn_npz") -> str:
    """Post-hoc corrupt a completed checkpoint pair — the damage an
    UNHARDENED saver (or bit rot / external deletion) produces, which the
    atomic write path can no longer create by crashing.  ``torn_npz``
    truncates the array file mid-byte; ``missing_npz`` deletes it,
    leaving a manifest pointing at nothing.  Returns the damaged path."""
    if mode not in TEAR_MODES:
        raise ValueError(f"unknown tear mode {mode!r}; "
                         f"expected one of {TEAR_MODES}")
    npz = os.path.join(directory, f"ckpt_{step}.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(npz)
    if mode == "missing_npz":
        os.remove(npz)
    else:
        size = os.path.getsize(npz)
        with open(npz, "r+b") as f:
            f.truncate(max(size // 3, 1))
    return npz


def make_save_crash_hook(stage: str, event: Optional[FaultEvent] = None):
    """A ``checkpoint.save(fault_hook=)`` that crashes (raises
    :class:`InjectedFault`) at ``stage`` — simulating preemption exactly
    at that durability boundary."""
    from repro_torch.checkpoint.ckpt import SAVE_STAGES
    if stage not in SAVE_STAGES:
        raise ValueError(f"unknown save stage {stage!r}; "
                         f"expected one of {SAVE_STAGES}")
    ev = event or FaultEvent(kind="ckpt_tear", round=0, mode=stage)

    def hook(at: str):
        if at == stage:
            raise InjectedFault(ev)
    return hook


def poison_channels(channels: dict) -> dict:
    """What a torn transfer delivers: the reward stream replaced with
    NaNs on the rewards' device (the downstream non-finite guard's
    detection surface)."""
    import torch
    out = dict(channels)
    out["rewards"] = torch.full_like(out["rewards"], float("nan"))
    return out
