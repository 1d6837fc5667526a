"""``ppo.gemm_ms``: device time in cuBLAS GEMM kernels per traced
iteration, in ms (the PPO update's products and the heads')."""
from gmibench import trace as tr


def read(ctx):
    t = ctx.trace
    us = [e - s for n, s, e in t.kernels
          if tr.kernel_group(n) == "GEMM (cuBLAS)"]
    return sum(us) / 1e3 / t.iterations if us else None
