"""xlstm-1.3b [ssm] — 48 blocks d_model=2048 4H vocab=50304; sLSTM + mLSTM
blocks at the xLSTM[7:1] ratio (6 super-blocks x (7 mLSTM + 1 sLSTM)).
d_ff=0: the recurrent blocks carry their own up/down projections.
[arXiv:2405.04517]
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="xlstm-1.3b", family="ssm", source="arXiv:2405.04517",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",), num_super=6,
    ssm_expansion=1,   # sized to the published 1.3B total (DESIGN.md §8)
    conv_width=4, dtype="bfloat16")


def reduced() -> ModelConfig:
    return FULL.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        vocab_size=512, block_pattern=("mlstm", "slstm"), num_super=1,
        dtype="float32")
