# Hand-written CUDA kernels for the hot path (sources in repro_torch/csrc/,
# built at first CUDA use by _build.py), their plain PyTorch versions in
# ref.py, and the device-dispatching wrappers in ops.py:
#   env_megakernel.py   — fused env step (physics + reset + obs + ring rows)
#   gae_scan.py         — fused GAE + global advantage normalisation
#   fused_policy_mlp.py — whole Table-6 policy trunk in one launch
from repro_torch.kernels import ops, ref  # noqa: F401
