"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b family]
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="stablelm-12b", family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=160,
    d_ff=13824, vocab_size=100_352, act="silu", dtype="bfloat16")


def reduced() -> ModelConfig:
    return FULL.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, dtype="float32")
