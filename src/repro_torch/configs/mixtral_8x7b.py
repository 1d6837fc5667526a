"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000; 8 experts top-2, sliding-window attention. [arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe", source="arXiv:2401.04088",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32_000,
    num_experts=8, experts_per_token=2,
    sliding_window=4096, act="silu", dtype="bfloat16")


def reduced() -> ModelConfig:
    return FULL.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=256, vocab_size=512, num_experts=4, experts_per_token=2,
        sliding_window=16, dtype="float32")
