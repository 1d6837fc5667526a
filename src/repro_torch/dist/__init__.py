from repro_torch.dist.partition import (batch_specs, cache_specs,  # noqa: F401
                                        param_specs)
