"""``idle_share``: the share of the traced iterations' wall time in which
no kernel ran on the card (1 - the union of kernel intervals over the
wall time), in %."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_us() / t.wall_us) if t.wall_us else None
