"""zamba2-7b [hybrid] — 81 layer applications, d_model=3584 32H (kv=32)
d_ff=14336, ssm_state=64: Mamba2 backbone with ONE shared attention+MLP
block applied periodically (9 super-blocks x (8 mamba2 + 1 shared-attn) =
81). [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b", family="hybrid", source="arXiv:2411.15242",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32_000, ssm_state_dim=64,
    block_pattern=("mamba2",) * 8 + ("attn_shared",), num_super=9,
    conv_width=4, act="silu", dtype="bfloat16")


def reduced() -> ModelConfig:
    return FULL.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, ssm_state_dim=16,
        block_pattern=("mamba2", "attn_shared"), num_super=1,
        dtype="float32")
