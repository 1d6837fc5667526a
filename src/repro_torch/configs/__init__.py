"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

A copy of ``repro/configs/`` (pure data): the 10 assigned architectures
(public-literature pool), all of which the port's model code runs.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                TrainConfig)  # noqa: F401

_ARCH_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "mixtral-8x7b": "mixtral_8x7b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen2-72b": "qwen2_72b",
    "hubert-xlarge": "hubert_xlarge",
    "stablelm-12b": "stablelm_12b",
    "xlstm-1.3b": "xlstm_1_3b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "zamba2-7b": "zamba2_7b",
    "pixtral-12b": "pixtral_12b",
}

ARCHS = tuple(_ARCH_MODULES.keys())


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).FULL


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def shape_skips(arch: str) -> dict:
    """Which input shapes are skipped for this arch, and why (DESIGN.md §5).

    ``long_500k`` notes: archs without native sub-quadratic attention run it
    only under the sliding-window serving variant (window_override)."""
    cfg = get_config(arch)
    skips = {}
    if cfg.is_encoder_only:
        skips["decode_32k"] = "encoder-only: no autoregressive decode step"
        skips["long_500k"] = "encoder-only: no autoregressive decode step"
    return skips


def long_context_window(arch: str):
    """window_override used for long_500k (None = native sub-quadratic)."""
    cfg = get_config(arch)
    if cfg.family in ("ssm", "hybrid"):
        return None                      # recurrent state: O(1) per token
    if cfg.sliding_window and not cfg.local_global:
        return None                      # native SWA (mixtral)
    return 4096                          # sliding-window serving variant
