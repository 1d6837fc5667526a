"""``mfu.ppo``: the model FLOPs of every PPO iteration the window
completed (``cost.ppo_iteration_flops``) over the window's seconds, as a
share of the TF32 dense peak, in %."""
from gmibench import cost, peaks


def read(ctx):
    w = ctx.window
    if not w["iterations"]:
        return None
    flops = cost.ppo_iteration_flops(ctx.config, ctx.traffic) \
        * w["iterations"]
    return 100.0 * flops / w["seconds"] / peaks.TF32_DENSE
