# Hand-written CUDA kernels for the hot path (sources in repro_torch/csrc/,
# built at first CUDA use by _build.py), their plain PyTorch versions in
# ref.py, and the device-dispatching wrappers in ops.py:
#   env_megakernel.py   — fused env step (physics + reset + obs + ring rows)
#   gae_scan.py         — fused GAE + global advantage normalisation, and
#                         the A3C n-step return scan
#   fused_policy_mlp.py — whole Table-6 policy trunk in one launch
#   channel_pack.py     — MCC ring buffers and the one-launch ring pack
#   paged_decode.py     — one-token GQA attention read through a page table
#                         (split-KV)
#   flash_attention.py  — blocked online-softmax attention (prefill)
#   mlstm_scan.py       — chunkwise mLSTM from a given state (xlstm prefill)
from repro_torch.kernels import ops, ref  # noqa: F401
