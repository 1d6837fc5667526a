"""Synthetic token/feature pipeline (port of ``repro/data/tokens.py``).

Deterministic, seekable batch generation (Zipf-ish marginals over a Markov
backbone so the LM loss has learnable structure).  The batches are numpy,
so the two packages draw the same tokens from the same seed.  The
reference's mesh placement has no counterpart yet: :func:`batch_iterator`
puts each batch on one device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig


def _markov_tokens(rng: np.random.Generator, batch: int, seq: int,
                   vocab: int) -> np.ndarray:
    """Order-1 Markov chain with Zipf marginals — compressible, non-trivial."""
    base = rng.zipf(1.5, size=(batch, seq)).astype(np.int64)
    toks = (base + np.cumsum(base, axis=1)) % vocab
    return toks.astype(np.int32)


def make_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
               seq_len: Optional[int] = None,
               global_batch: Optional[int] = None) -> Dict[str, np.ndarray]:
    """One host-side batch dict matching the model family's inputs."""
    rng = np.random.default_rng(seed)
    S = seq_len or shape.seq_len
    B = global_batch or shape.global_batch
    if cfg.frontend == "audio":
        feats = rng.standard_normal((B, S, cfg.frontend_feat_dim),
                                    dtype=np.float32)
        mask = rng.random((B, S)) < 0.15
        targets = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        return {"features": feats, "mask": mask, "targets": targets}
    if cfg.frontend == "vision":
        ptc = rng.standard_normal((B, cfg.num_patches, cfg.frontend_feat_dim),
                                  dtype=np.float32)
        T = max(S - cfg.num_patches, 8)
        toks = _markov_tokens(rng, B, T, cfg.vocab_size)
        return {"tokens": toks, "labels": toks, "patches": ptc}
    toks = _markov_tokens(rng, B, S, cfg.vocab_size)
    return {"tokens": toks, "labels": toks}


def batch_iterator(cfg: ModelConfig, shape: InputShape, *, seed: int = 0,
                   device="cpu") -> Iterator[Dict]:
    """Endless iterator of batches as tensors on ``device``."""
    step = 0
    while True:
        host = make_batch(cfg, shape, seed=seed + step)
        yield {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        step += 1
