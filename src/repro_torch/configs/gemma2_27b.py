"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; local+global alternating attention, logit softcaps.
[arXiv:2408.00118]
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="gemma2-27b", family="dense", source="arXiv:2408.00118",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256_000,
    local_global=True, sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    act="silu", tie_embeddings=True, dtype="bfloat16")


def reduced() -> ModelConfig:
    return FULL.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, sliding_window=16, dtype="float32")
