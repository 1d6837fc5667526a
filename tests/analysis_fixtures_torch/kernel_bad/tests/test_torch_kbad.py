from pkg.kernels import ops


def test_k_op(x):
    assert ops.k_op(x) is not None
