"""Production presets: the best-known runtime knobs per (arch × shape),
a copy of ``repro/configs/presets.py``.

Usage: ``preset(arch, shape)`` returns kwargs for
``repro_torch.launch.dryrun.run_one`` / the step factories: the same dict
as the reference for every arch and shape.  The dry run records every
knob, but on one card two of them change nothing: the port's
``make_train_step`` has no ``act_sharding`` (activations are not
sharded) and its ``make_serve_step`` no ``unroll`` (the decode stack
runs layer by layer in Python either way).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import get_config

# train_4k microbatch counts that bring activations under 16 GiB/chip
_TRAIN_MB = {
    "gemma2-27b": 2, "mixtral-8x7b": 4, "qwen2-72b": 4, "stablelm-12b": 2,
    "pixtral-12b": 2, "zamba2-7b": 4, "xlstm-1.3b": 4,
    "granite-moe-1b-a400m": 2, "internlm2-1.8b": 1, "hubert-xlarge": 1,
}

# activation layout is SHAPE-dependent: seq sharding wins for xlstm
# PREFILL (-9.3x collectives, keeps per-timestep slices local) but loses
# for its TRAIN backward (6x traffic); granite needs seq under
# microbatching to sidestep a GSPMD gather bug
_ACT = {("xlstm-1.3b", "prefill_32k"): "seq",
        ("granite-moe-1b-a400m", "train_4k"): "seq"}


def preset(arch: str, shape_name: str) -> Dict:
    cfg = get_config(arch)
    out: Dict = {"lgr": "har",
                 "act_sharding": _ACT.get((arch, shape_name), "dmodel"),
                 "cache_layout": "heads", "microbatches": 1,
                 "moe_spec": "contract", "decode_unroll": False}
    if shape_name == "train_4k":
        out["microbatches"] = _TRAIN_MB.get(arch, 1)
    if shape_name in ("decode_32k", "long_500k"):
        # kv_heads < |model|=16 → head-dim sharding would re-gather the
        # cache every layer; sequence-sharded cache keeps scores local
        if cfg.num_kv_heads and cfg.num_kv_heads < 16 and \
                not cfg.block_pattern:
            out["cache_layout"] = "seq"
        # local/global stacks: per-layer ring caches halve KV memory
        if cfg.local_global:
            out["per_layer_cache"] = True
            out["decode_unroll"] = True
    out.setdefault("per_layer_cache", False)
    return out
