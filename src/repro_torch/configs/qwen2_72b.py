"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; QKV bias. [arXiv:2407.10671]
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2-72b", family="dense", source="arXiv:2407.10671",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152_064, qkv_bias=True, act="silu",
    dtype="bfloat16")


def reduced() -> ModelConfig:
    return FULL.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, dtype="float32")
