"""``env_mega_step_roofline``: the least time one launch of the env step
kernel could take at its shapes (``cost.env_mega_step_bound_s``) over the
mean device time of its launches in the traced iterations, in %."""
from gmibench import cost

KERNEL = "env_mega_step"


def read(ctx):
    ks = ctx.trace.kernel_intervals(KERNEL)
    if not ks:
        return None
    mean_s = sum(e - s for s, e in ks) / len(ks) / 1e6
    c = ctx.config
    return 100.0 * cost.env_mega_step_bound_s(
        ctx.traffic["envs_per_gmi"], c["act_dim"], c["obs_dim"],
        c["env_model"]["substeps"]) / mean_s
