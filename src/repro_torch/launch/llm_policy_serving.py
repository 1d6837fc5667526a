"""Serve a (reduced) assigned architecture with batched requests: a thin
client of the ``repro_torch.serve`` continuous-batching engine
(runnable counterpart of ``examples/llm_policy_serving.py``).

Every family serves as in the reference: text prompts only (pixtral's
patches are ``launch/serve.py``'s), and an encoder-only arch (hubert)
exits with ``shape_skips``' reason.

    PYTHONPATH=src python -m repro_torch.launch.llm_policy_serving \\
        --arch xlstm-1.3b --device cuda
    PYTHONPATH=src python -m repro_torch.launch.llm_policy_serving \\
        --arch granite-moe-1b-a400m --device cuda
    PYTHONPATH=src python -m repro_torch.launch.llm_policy_serving \\
        --arch internlm2-1.8b --device cpu --batch 2 --gen 4
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCHS, get_reduced, shape_skips
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-1.3b", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if "decode_32k" in shape_skips(args.arch):
        raise SystemExit(f"{args.arch}: " +
                         shape_skips(args.arch)["decode_32k"])
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    print(f"serving {args.arch} (reduced: {cfg.d_model}d) — "
          f"family={cfg.family}, device={device}")
    params = T.init_model(0, cfg, device)
    B, P = args.batch, args.prompt_len
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P))

    engine = ServeEngine(cfg, params, max_slots=B,
                         max_seq=P + args.gen + 4, device=device)
    done = engine.serve([Request(tokens=toks[i], max_new_tokens=args.gen)
                         for i in range(B)])

    tel = engine.telemetry
    print(f"prefill {B}x{P}: {1e3 * tel.total_prefill_s:.1f} ms")
    gen_tokens = tel.total_tokens - B          # first tokens came from prefill
    print(f"decode {tel.total_decode_steps} steps: "
          f"{1e3 * tel.total_decode_s:.1f} ms "
          f"({gen_tokens/max(tel.total_decode_s, 1e-9):,.0f} tok/s batched)")
    first = min(done, key=lambda c: c.rid)
    print("first sequence token ids:", first.tokens[:12], "...")
    return done


if __name__ == "__main__":
    main()
