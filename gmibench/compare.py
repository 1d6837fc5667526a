"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings (``references/ppo_chain.run``'s
format) of the first checked iterations: each iteration's loss per GMI;
after the first iteration every env's observation, each GMI's first
gradient as its optimizer got it and its Adam first moment (norms per
leaf); and the change of the params over all of them (its norm per
leaf).  Five numbers come out, each the worst over what it covers:

* ``loss_gap``: |program - reference| of a GMI's loss in the first
  iteration (absolute: a PPO loss passes near 0).  The later
  iterations' losses are not compared: Adam turns round-off into steps
  of a few leaves there, so their gap grows with no fault (PERF.md);
* ``obs_gap``: the 99th percentile over every env's observation
  elements of |program - reference| after the first iteration: the env
  step, the acting trunk and the heads element by element (a share of
  Humanoid's envs ends or not on a rounding, and resets);
* ``grad_gap``: the gap between the two norms of a leaf of a GMI's first
  gradient, against the reference's norm of that leaf or of the median
  leaf, whichever is larger: the update's products (the loss's forward
  and backward GEMMs) and its inputs (the rollout, GAE), read before any
  Adam step turns their rounding into steps;
* ``moment_gap``: the gap between the two norms of a leaf's first
  moment, against the reference's norm of that leaf or of the median
  leaf, whichever is larger;
* ``change_gap``: the same of the params' change, over the leaves whose
  reference first moment is at least ``SKIP`` of the median leaf's (a
  leaf whose gradient is nought to rounding moves under Adam by
  round-off alone).

A number that is not finite is null, and fails.
"""
from __future__ import annotations

import math
import statistics

import numpy as np

SKIP = 1e-3
OBS_QUANTILE = 0.99
NUMBERS = ("loss_gap", "obs_gap", "grad_gap", "moment_gap", "change_gap")


def _worst(values) -> float:
    """The largest of ``values``; infinite where one is not finite."""
    values = list(values)
    return max(values) if all(map(math.isfinite, values)) else math.inf


def _leaf_gap(got: dict, want: dict, keep=None) -> float:
    """A leaf missing from ``got`` reads not finite."""
    names = [k for k in want if keep is None or k in keep]
    med = statistics.median(want.values())
    return _worst(abs(got.get(k, math.nan) - want[k]) / max(want[k], med)
                  for k in names)


def gaps(got: dict, want: dict) -> dict:
    """The numbers of program readings ``got`` against reference readings
    ``want``."""
    loss = _worst(abs(g - w) for g, w in zip(got["loss"][0],
                                             want["loss"][0]))
    diff = np.abs(got["obs"].astype(np.float64) - want["obs"])
    obs = float(np.quantile(diff, OBS_QUANTILE)) \
        if np.isfinite(diff).all() else math.inf
    grad = _worst(_leaf_gap(g, w) for g, w in zip(got["grad"],
                                                  want["grad"]))
    moment = _worst(_leaf_gap(g, w) for g, w in zip(got["moment"],
                                                    want["moment"]))
    top = {k: max(m[k] for m in want["moment"]) for k in want["change"]}
    med = statistics.median(top.values())
    keep = {k for k, v in top.items() if v >= SKIP * med}
    change = _leaf_gap(got["change"], want["change"], keep)
    out = {"loss_gap": loss, "obs_gap": obs, "grad_gap": grad,
           "moment_gap": moment, "change_gap": change}
    return {k: (v if math.isfinite(v) else None) for k, v in out.items()}


def judge(numbers: dict, limits: dict):
    """(correct, checks): each number beside its limit.  A limit of None
    marks a number that is read and not compared."""
    checks, ok = {}, True
    for k in NUMBERS:
        v, lim = numbers.get(k), limits.get(k)
        checks[k] = {"value": v, "limit": lim}
        if v is None or (lim is not None and v > lim):
            ok = False
    return ok, checks
