def k_op(x):
    from pkg.kernels import k
    return k.launch(x)          # BAD: no plain version in ref.py
