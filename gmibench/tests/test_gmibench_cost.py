"""The work the benchmark divides by: the policies' model FLOPs a
sample and an iteration, and the frozen kernel counts against the port's
own formulas at the cells' shapes."""
import pytest

import _tiny  # noqa: F401  (puts the checkout on sys.path)

CELLS = ("shadowhand.ppo.gmi1", "humanoid.ppo.gmi4", "humanoid.ppo.gmi1")


def test_forward_flops():
    from gmibench import cost
    assert cost.forward_flops([211, 512, 512, 512, 256, 20]) == 1_537_536
    assert cost.forward_flops([108, 200, 400, 100, 21]) == 287_600


@pytest.mark.parametrize("cell, tflop", [
    ("shadowhand.ppo.gmi1", 1_537_536 * 65536 * 209),
    ("humanoid.ppo.gmi1", 287_600 * 131072 * 209),
    ("humanoid.ppo.gmi4", 287_600 * 131072 * 209)])
def test_iteration_flops(cell, tflop):
    from gmibench import cost, spec
    c = spec.load(cell)
    # 16 acting passes + the bootstrap, and 4 epochs x 16 steps x 3
    assert cost.ppo_iteration_flops(c.config, c.traffic) == tflop


@pytest.mark.parametrize("cell", CELLS)
def test_kernel_counts_match_the_port(cell):
    from gmibench import cost, peaks, spec
    from repro_torch.kernels import cost as port
    c = spec.load(cell)
    cfg, n = c.config, c.traffic["envs_per_gmi"]
    dims = cfg["policy_dims"][:-1]
    assert cost.policy_mlp(dims, n) == port.policy_mlp(dims, n)
    b, proj, rest = cost.env_mega_step(n, cfg["act_dim"], cfg["obs_dim"], 4)
    pb, pops = port.env_mega_step(n, cfg["act_dim"], cfg["obs_dim"], 4)
    assert b == pb and [proj, rest] == [o for o, _ in pops]
    # a trunk call is bound by its operations counted once at the TF32
    # peak, an env step by its bytes
    bb, ops = cost.policy_mlp(dims, n)
    assert cost.policy_mlp_bound_s(dims, n) == ops / peaks.TF32_DENSE
    assert cost.env_mega_step_bound_s(
        n, cfg["act_dim"], cfg["obs_dim"], 4) == b / peaks.HBM_BYTES_PER_S
