from pkg.kernels import ref


class _K:
    @staticmethod
    def forward(x):
        from pkg.kernels import k as kk
        return kk.launch(x)


def k_op(x):
    if x.device.type == "cpu":
        return ref.k_ref(x)
    return _K.forward(x)
