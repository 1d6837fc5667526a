from pkg.kernels import ops


def check(x):
    return ops.k_op(x.cuda())
