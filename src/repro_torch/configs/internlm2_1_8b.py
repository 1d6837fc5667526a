"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544. [arXiv:2403.17297]
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="internlm2-1.8b", family="dense", source="arXiv:2403.17297",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92_544, act="silu", dtype="bfloat16")


def reduced() -> ModelConfig:
    return FULL.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, dtype="float32")
