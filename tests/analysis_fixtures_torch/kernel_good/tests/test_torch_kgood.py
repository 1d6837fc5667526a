from pkg.kernels import ops, ref


def test_k_op_matches_plain(x):
    assert ops.k_op(x) == ref.k_ref(x)
