"""Architecture configuration schema.

Every assigned architecture gets a ``ModelConfig`` (full size, used only by
the dry-run via ShapeDtypeStruct) plus a ``reduced()`` variant (<=2 layers,
d_model<=512, <=4 experts) that the CPU smoke tests instantiate for real.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""               # citation for the config numbers

    # trunk dimensions ----------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention features --------------------------------------------------
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None     # pre-softmax logit softcap
    final_softcap: Optional[float] = None    # lm-head logit softcap
    sliding_window: Optional[int] = None     # SWA width (None = full)
    local_global: bool = False               # gemma2: alternate local/global
    causal: bool = True                      # False => encoder-only

    # MoE ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    # Routing-block size R (0 = whole sequence): capacity competition is
    # confined to R-token blocks at absolute positions, making routing
    # independent of batch composition AND of prefill chunking whenever
    # chunk boundaries land on multiples of R.
    moe_route_block: int = 0

    # SSM / hybrid ---------------------------------------------------------
    # block pattern within one "super-block"; the stack is
    # num_super * len(pattern) layer applications.  "attn_shared" entries all
    # reuse ONE weight set (zamba2-style shared block).
    block_pattern: Tuple[str, ...] = ()      # e.g. ("mlstm",)*7 + ("slstm",)
    num_super: int = 0
    ssm_state_dim: int = 0
    ssm_expansion: int = 2         # inner-dim expansion of recurrent blocks
    conv_width: int = 4

    # modality frontend stubs ----------------------------------------------
    frontend: Optional[str] = None           # "audio" | "vision"
    frontend_feat_dim: int = 0               # raw embedding dim fed by stub
    num_patches: int = 0                     # vision: patches per request

    # misc -------------------------------------------------------------------
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "float32"                   # compute dtype for dry-runs

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Flat sequence of per-layer block kinds for the whole stack."""
        if self.block_pattern:
            return tuple(self.block_pattern) * self.num_super
        return ("attn",) * self.num_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # rough parameter count (embedding + trunk), for config sanity tests ----
    def approx_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        q = self.num_heads * hd
        kv = self.num_kv_heads * hd
        n = 0
        n += v * d                                   # embed
        if not self.tie_embeddings:
            n += v * d                               # unembed
        per_attn = d * q + 2 * d * kv + q * d
        per_mlp = 3 * d * f if self.act in ("silu", "swiglu") else 2 * d * f
        if self.num_experts:
            per_mlp *= self.num_experts
            per_mlp += d * self.num_experts          # router
        for kind in self.layer_kinds:
            if kind in ("attn", "attn_shared"):
                n += per_attn + per_mlp if kind == "attn" else 0
            elif kind == "mlstm":
                n += 2 * d * (2 * d) + 2 * d * d     # up/gate + qkv-ish + down
            elif kind == "slstm":
                n += 8 * d * d // 4
            elif kind == "mamba2":
                n += 2 * d * (2 * d) + d * self.ssm_state_dim * 4
        if "attn_shared" in self.layer_kinds:
            n += per_attn + per_mlp                  # one shared copy
        return n


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""
    name: str
    seq_len: int
    global_batch: int
    mode: str        # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 10
    total_steps: int = 100
    # GMI-DRL runtime knobs
    lgr_strategy: str = "auto"       # auto | mpr | mrr | har
    gmi_layout: str = "tcg"          # tcg | tdg
    remat: bool = True
    microbatches: int = 1            # gradient-accumulation splits
