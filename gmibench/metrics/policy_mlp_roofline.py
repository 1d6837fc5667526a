"""``policy_mlp_roofline``: the least time one call of the fused trunk
could take at its shapes (``cost.policy_mlp_bound_s``) over the device
time of one call in the traced iterations, in %.  A call launches two
kernels, the weights' split and the trunk; its time is both kernels'
time over the trunk kernel's launches."""
from gmibench import cost

KERNELS = "fused_policy_mlp"
CALL = "fused_policy_mlp_kernel"


def read(ctx):
    t = ctx.trace
    calls = len(t.kernel_intervals(CALL))
    if not calls:
        return None
    call_s = sum(e - s for s, e in t.kernel_intervals(KERNELS)) / calls / 1e6
    dims = ctx.config["policy_dims"][:-1]
    return 100.0 * cost.policy_mlp_bound_s(
        dims, ctx.traffic["envs_per_gmi"]) / call_s
