def other_ref(x):
    return x
