from repro_torch.optim.adam import AdamState, adam_init, adam_update  # noqa: F401
