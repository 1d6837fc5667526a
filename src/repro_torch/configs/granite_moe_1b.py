"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
per expert, 32 experts top-8, vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49_155,
    num_experts=32, experts_per_token=8, act="silu", tie_embeddings=True,
    dtype="bfloat16")


def reduced() -> ModelConfig:
    return FULL.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=128, vocab_size=512, num_experts=4, experts_per_token=2,
        dtype="float32")
