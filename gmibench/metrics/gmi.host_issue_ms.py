"""``gmi.host_issue_ms``: host time inside each GMI's step (the step the
benchmark hands to ``train_gmis``, timed by the host's clock), summed
over the GMIs, per traced iteration, in ms."""


def read(ctx):
    t = ctx.trace
    return 1e3 * sum(t.step_s) / t.iterations if t.step_s else None
