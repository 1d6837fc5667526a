from repro_torch.checkpoint.ckpt import (latest_step, load,  # noqa: F401
                                         load_manifest, save, steps)
