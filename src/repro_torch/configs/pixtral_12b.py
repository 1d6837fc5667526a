"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT vision encoder + mistral-nemo decoder.  The ViT is
a STUB: input_specs() feeds projected patch embeddings (B, P, 1024) that are
interleaved ahead of the text tokens. [hf:mistralai/Pixtral-12B-2409]
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="pixtral-12b", family="vlm", source="hf:mistralai/Pixtral-12B-2409",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131_072,
    frontend="vision", frontend_feat_dim=1024, num_patches=256,
    act="silu", dtype="bfloat16")


def reduced() -> ModelConfig:
    return FULL.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, frontend_feat_dim=64, num_patches=8,
        dtype="float32")
