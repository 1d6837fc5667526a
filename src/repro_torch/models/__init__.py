from repro_torch.models import policy  # noqa: F401
