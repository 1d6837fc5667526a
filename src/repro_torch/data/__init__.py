from repro_torch.data.tokens import batch_iterator, make_batch  # noqa: F401
