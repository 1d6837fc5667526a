"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504
(k-means target codebook); encoder-only, same trunk as wav2vec2.
The conv/mel frontend is a STUB: input_specs() feeds precomputed frame
embeddings (B, T, 512). [arXiv:2106.07447]
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="hubert-xlarge", family="audio", source="arXiv:2106.07447",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504, causal=False,
    frontend="audio", frontend_feat_dim=512, act="gelu", dtype="bfloat16")


def reduced() -> ModelConfig:
    return FULL.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=64, frontend_feat_dim=32, dtype="float32")
