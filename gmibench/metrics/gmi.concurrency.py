"""``gmi.concurrency``: the kernels' summed device time over the union of
their intervals in the traced iterations: 1 where no two kernels
overlap, up to the number of GMIs where all run at once."""
from gmibench import trace as tr


def read(ctx):
    ks = ctx.trace.kernel_intervals()
    return tr.concurrency(ks) if ks else None
