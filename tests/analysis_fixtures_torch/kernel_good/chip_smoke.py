from pkg.kernels import ops, ref


def check(x):
    return ops.k_op(x.cuda()).cpu() - ref.k_ref(x)
