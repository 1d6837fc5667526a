"""Serving launcher — a thin CLI over the ``repro_torch.serve`` engine
(port of ``repro/launch/serve.py``): batched prefill through the flash
kernel (attention stacks) or the mLSTM kernel (xlstm), and
continuous-batching decode through the paged gather-decode kernel
(attention stacks; xlstm's recurrent decode is plain ops).  The reference
serves the reduced configs because its host is a CPU; ``--full`` takes
the published widths, which fit one H100 (gemma2-27b's only in bf16:
the weights are drawn straight into ``cfg.dtype``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --full --device cuda \\
      --batch 8 --prompt-len 512 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --full --device cuda --batch 8 --prompt-len 512 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \\
      --full --device cuda --batch 2 --prompt-len 4608 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --batch 4 --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg --full \\
      --device cuda --decode-engines 2 --prefill-gmis 1 --batch 8 \\
      --prompt-len 512 --gen 64

xlstm's whole-prompt prefill runs its mLSTM blocks in chunks of
``min(256, prompt)`` steps, which must divide the prompt length, as in the
reference.  A vision arch (pixtral-12b) sends each request's patch
embeddings (``make_batch``'s ``patches``) in ``Request.extras``, ahead of
its text tokens; an encoder-only arch (hubert-xlarge) exits, as in the
reference.

``--disagg`` serves through the disaggregated front instead
(``launch/steps.py::make_disagg_front``): prefill specialists feeding
decode engines over the cache-migration channel, with the per-request
migrate-vs-local decision priced by the Table-2 cost model
(``serve/disagg.py``).  Every decode engine and prefill GMI is a GMI of a
``GMIManager`` on the MIG-like backend, so on the card each runs under
its own CUDA stream; all of them share one copy of the parameters.

Weights are random from ``--seed``.
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
    ap.add_argument("--disagg", action="store_true",
                    help="serve through the disaggregated prefill/decode "
                         "front (cache migration between GMIs)")
    ap.add_argument("--decode-engines", type=int, default=2,
                    help="decode GMIs behind the router (--disagg)")
    ap.add_argument("--prefill-gmis", type=int, default=1,
                    help="prefill-specialist GMIs (--disagg)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_config if args.full else get_reduced)(args.arch)
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    params = T.init_model(args.seed, cfg, device, cast=True)
    shape = InputShape("serve", args.prompt_len, args.batch, "prefill")
    batch = make_batch(cfg, shape, seed=args.seed)
    requests = []
    for i in range(args.batch):
        extras = {"patches": batch["patches"][i]} \
            if cfg.frontend == "vision" else None
        requests.append(Request(tokens=batch["tokens"][i],
                                max_new_tokens=args.gen,
                                temperature=args.temperature,
                                seed=args.seed + i, extras=extras))

    if args.disagg:
        return _serve_disagg(args, cfg, params, device, requests)

    engine = ServeEngine(cfg, params, max_slots=args.batch,
                         max_seq=args.prompt_len + args.gen + 8,
                         device=device)
    del params
    done = engine.serve(requests)

    tel = engine.telemetry
    B = args.batch
    gen_tokens = tel.total_tokens - B          # B first tokens are prefill's
    first = next(c for c in done if c.rid == requests[0].rid)
    prompt_tokens = len(requests[0].tokens) + (
        cfg.num_patches if cfg.frontend == "vision" else 0)
    print(f"arch={args.arch} {'full' if args.full else 'reduced'} "
          f"device={device} batch={B} prompt={prompt_tokens} "
          f"gen={args.gen}")
    print(f"prefill: {tel.total_prefill_s*1e3:.1f} ms "
          f"({tel.total_prompt_tokens/max(tel.total_prefill_s,1e-9):,.0f} "
          f"tok/s)")
    print(f"decode:  {tel.total_decode_s*1e3:.1f} ms "
          f"({gen_tokens/max(tel.total_decode_s,1e-9):,.0f} tok/s)")
    print("sample token ids:", first.tokens[:16])
    return done


def _serve_disagg(args, cfg, params, device, requests):
    from repro_torch.core.gmi import GMIManager
    from repro_torch.launch.steps import make_disagg_front
    n = args.decode_engines + max(args.prefill_gmis, 1)
    manager = GMIManager(devices=list(range(n)), devices_per_gpu=n,
                         backend="submesh", device=device)
    front = make_disagg_front(
        cfg, params, decode_engines=args.decode_engines,
        prefill_gmis=args.prefill_gmis, max_slots=args.batch,
        max_seq=args.prompt_len + args.gen + 8, manager=manager)
    done = front.serve(requests)
    load = front.take_epoch()
    pl = front.planner
    print(f"arch={args.arch} {'full' if args.full else 'reduced'} "
          f"device={device} batch={args.batch} disagg: "
          f"{len(front.prefill_engines)} prefill + {front.num_engines} "
          f"decode GMI(s)")
    print(manager.summary())
    print(f"migrated={pl.migrated} local={pl.kept_local} "
          f"bw={pl.bandwidth/1e9:.2f} GB/s "
          f"prefill_rate={pl.prefill_tok_s:,.0f} tok/s "
          f"prefix_pages_saved={front.prefix_pages_saved}")
    print(f"tokens={load.tokens} p50={load.p50_s*1e3:.1f} ms "
          f"p95={load.p95_s*1e3:.1f} ms")
    first = next(c for c in done if c.rid == requests[0].rid)
    print("sample token ids:", first.tokens[:16])
    return done


if __name__ == "__main__":
    main()
