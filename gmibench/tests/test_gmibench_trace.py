"""Interval arithmetic, the kernel groups and the trace-reading metrics on
hand-made intervals."""
import pytest

import _tiny  # noqa: F401  (puts the checkout on sys.path)


def test_union_and_concurrency():
    from gmibench import trace as tr
    assert tr.union_us([]) == 0.0 and tr.concurrency([]) == 0.0
    ivs = [(0, 10), (5, 15), (20, 30), (22, 24)]
    assert tr.union_us(ivs) == 25.0
    assert tr.concurrency(ivs) == pytest.approx((10 + 10 + 10 + 2) / 25)
    assert tr.concurrency([(0, 1), (1, 2)]) == 1.0
    assert tr.idle_gaps(ivs, -5, 40) == [(-5, 0), (15, 20), (30, 40)]
    assert tr.idle_gaps([(0, 50)], 10, 40) == []


def test_kernel_groups():
    from gmibench import trace as tr
    assert tr.kernel_group("fused_policy_mlp_split_kernel") == \
        "fused_policy_mlp (port kernel)"
    assert tr.kernel_group("sm90_xmma_gemm_f32f32_tf32f32") == \
        "GEMM (cuBLAS)"
    assert tr.kernel_group("nvjet_tst_128x64") == "GEMM (cuBLAS)"
    assert tr.kernel_group("vectorized_elementwise_kernel") == "other"


KERNELS = [("env_mega_step_kernel", 0, 10), ("gemm_a", 5, 25),
           ("fused_policy_mlp_split_kernel", 40, 42),
           ("fused_policy_mlp_kernel", 42, 50),
           ("fused_policy_mlp_split_kernel", 60, 62),
           ("fused_policy_mlp_kernel", 62, 70)]


def _trace():
    from gmibench import trace as tr
    return tr.Trace(KERNELS, wall_us=100.0, start_us=0.0, iterations=2,
                    step_s=[30e-6, 50e-6], gaps=[])


def test_trace_breakdown():
    from gmibench import trace as tr
    t = _trace()
    assert t.busy_us() == 25 + 10 + 10
    top = t.top_kernels(2)
    assert [n for n, _ in top] == ["gemm_a", "fused_policy_mlp_kernel"]
    assert [s for _, s in top] == pytest.approx([20e-6, 16e-6])
    p = tr.RANGE_PREFIX
    ranges = [(p + "iteration", 0, 100), (p + "step.gmi0", 0, 30),
              (p + "step.gmi1", 30, 80)]
    host = [("aten::randperm", 24, 39), ("cudaDeviceSynchronize", 65, 100)]
    gaps = tr.named_gaps(KERNELS, ranges, host, 0.0, 100.0)
    assert [n for n, _ in gaps] == ["step.gmi1 > cudaDeviceSynchronize",
                                    "step.gmi0 > aten::randperm",
                                    "step.gmi1"]
    assert [s for _, s in gaps] == pytest.approx([30e-6, 15e-6, 10e-6])


def test_trace_metrics():
    from gmibench import spec
    t = _trace()
    cell = spec.load("shadowhand.ppo.gmi1")
    ctx = spec.Context(cell.config, cell.traffic,
                       {"iterations": 0, "seconds": 1.0}, t)
    read = lambda m: spec.reader(m).read(ctx)
    assert read("gmi.host_issue_ms") == pytest.approx(80 / 1e3 / 2)
    assert read("ppo.gemm_ms") == pytest.approx(20 / 1e3 / 2)
    assert read("idle_share") == pytest.approx(55.0)
    assert read("gmi.concurrency") == pytest.approx(50 / 45)
    assert read("mfu.ppo") is None
    from gmibench import cost
    bound = cost.policy_mlp_bound_s([211, 512, 512, 512, 256], 65536)
    assert read("policy_mlp_roofline") == pytest.approx(
        100 * bound / 10e-6)
    bound = cost.env_mega_step_bound_s(65536, 20, 211, 4)
    assert read("env_mega_step_roofline") == pytest.approx(
        100 * bound / 10e-6)
