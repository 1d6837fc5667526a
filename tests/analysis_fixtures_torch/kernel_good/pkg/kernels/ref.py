def k_ref(x):
    return x
