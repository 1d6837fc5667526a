from repro_torch.optim.adam import (AdamState, SGDState, adam_init,  # noqa: F401
                                    adam_update, cosine_warmup, sgd_init,
                                    sgd_update)
