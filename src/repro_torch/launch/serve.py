"""Serving launcher — a thin CLI over the ``repro_torch.serve`` engine
(port of ``repro/launch/serve.py``): batched prefill through the flash
kernel (attention stacks) or the mLSTM kernel (xlstm), and
continuous-batching decode through the paged gather-decode kernel
(attention stacks; xlstm's recurrent decode is plain ops).  The reference
serves the reduced configs because its host is a CPU; ``--full`` takes
the published widths, which fit one H100.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --full --device cuda \\
      --batch 8 --prompt-len 512 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --full --device cuda --batch 8 --prompt-len 512 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --batch 4 --prompt-len 16 --gen 8

xlstm's whole-prompt prefill runs its mLSTM blocks in chunks of
``min(256, prompt)`` steps, which must divide the prompt length, as in the
reference.

Weights are random from ``--seed``.  The disaggregated front
(``--disagg``) comes with ``serve/disagg.py`` in a later slice.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import InputShape
from repro_torch.data import make_batch
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--full", action="store_true",
                    help="published widths (get_config) instead of the "
                         "reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_config if args.full else get_reduced)(args.arch)
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    params = T.init_model(args.seed, cfg, device)
    shape = InputShape("serve", args.prompt_len, args.batch, "prefill")
    batch = make_batch(cfg, shape, seed=args.seed)
    requests = [Request(tokens=batch["tokens"][i], max_new_tokens=args.gen,
                        temperature=args.temperature, seed=args.seed + i)
                for i in range(args.batch)]

    engine = ServeEngine(cfg, params, max_slots=args.batch,
                         max_seq=args.prompt_len + args.gen + 8,
                         device=device)
    del params
    done = engine.serve(requests)

    tel = engine.telemetry
    B = args.batch
    gen_tokens = tel.total_tokens - B          # B first tokens are prefill's
    first = next(c for c in done if c.rid == requests[0].rid)
    print(f"arch={args.arch} {'full' if args.full else 'reduced'} "
          f"device={device} batch={B} prompt={len(requests[0].tokens)} "
          f"gen={args.gen}")
    print(f"prefill: {tel.total_prefill_s*1e3:.1f} ms "
          f"({tel.total_prompt_tokens/max(tel.total_prefill_s,1e-9):,.0f} "
          f"tok/s)")
    print(f"decode:  {tel.total_decode_s*1e3:.1f} ms "
          f"({gen_tokens/max(tel.total_decode_s,1e-9):,.0f} tok/s)")
    print("sample token ids:", first.tokens[:16])
    return done


if __name__ == "__main__":
    main()
