"""Both packages' Adam updates, recorded for the parity tests of a whole
PPO iteration (``test_torch_ppo.py``, ``test_torch_gmi.py``) and of an
A3C trainer update (``test_torch_a3c.py``).

Adam divides by ``sqrt(vhat) + eps``: where a gradient element is a few
eps, it turns the float noise of that gradient (~1e-9) into ~1e-6 of the
params (ROADMAP C10, C17).  So these tests hold the gradients Adam is
fed, and the params within a bound plus what Adam makes of those
gradient differences (``chip_smoke.adam_slack``, which the card's check
of the same iteration uses too).
"""
import os
import sys

import jax

from repro.rl import ppo as jppo
from repro_torch.rl import ppo as tppo

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

# Adam's constants in both packages' train_iteration
LR, B1, B2, EPS = 3e-4, 0.9, 0.999, 1e-8
# the gradient each Adam update is given, port against reference, as a
# share of the leaf's largest gradient: float noise of the sums behind
# it, at most 4.05e-05 over 248 sensor draws of the multi-GMI run
# (``test_torch_gmi.py --sweep``, ROADMAP C10)
GRAD_RTOL = 1e-4
# a gradient the port computed, against the reference's at the same
# params and experience, as a share of its leaf's largest over a run of
# updates (``run_grad_share``): float noise of at most 8.92e-07 over the
# async runner's sensor draws 0-139 and the CRC-32 of "Ant" (ROADMAP C22)
RUN_GRAD_RTOL = 1e-5
adam_slack = cs.adam_slack
grad_share = cs.grad_share


def run_grad_share(a, b) -> float:
    """The largest gradient difference of two Adam records, ``a`` the
    reference's, as a share of its leaf's largest gradient in ``a`` over
    the whole run.  Where a leaf's gradient cancels to a hundredth of its
    usual size at one update (the async runner's value bias, 5.5e-4 at
    sensor draw 124, ROADMAP C22), its float noise stays that of the terms
    it sums (5.7e-8), and ``grad_share`` would read it against the small
    sum (1.03e-4; 2.27e-4 at draw 35)."""
    import numpy as np
    scale = [max(float(np.abs(x).max()) for x in leaf)
             for leaf in zip(*(g for g, *_ in a))]
    return max(float(np.abs(y - x).max()) / max(s, 1e-30)
               for (ga, *_), (gb, *_) in zip(a, b)
               for x, y, s in zip(ga, gb, scale))


def record_adam(monkeypatch, rec, jmod=jppo, tmod=tppo):
    """Wrap both packages' ``adam_update``, as the modules ``jmod`` (the
    reference's) and ``tmod`` (the port's) call it, so that every update
    appends, leaf by leaf, the raw gradients it was given and the moments
    (m, v) and step it leaves: ``rec["j"]`` the reference's, ``rec["t"]``
    the port's, in the same order (GMI, epoch, minibatch)."""
    jadam = jmod.adam_update

    def keep(g, m, v, step):
        rec["j"].append((g, m, v, int(step)))

    def jwrap(grads, state, params, **kw):
        p2, s2 = jadam(grads, state, params, **kw)
        jax.debug.callback(keep, jax.tree.leaves(grads),
                           jax.tree.leaves(s2.mu), jax.tree.leaves(s2.nu),
                           s2.step, ordered=True)
        return p2, s2
    monkeypatch.setattr(jmod, "adam_update", jwrap)
    monkeypatch.setattr(tmod, "adam_update",
                        cs.recording_adam(tmod.adam_update, rec["t"]))
