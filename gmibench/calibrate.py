"""The readings the comparison's limits are set from, for one cell.

    env PYTHONHASHSEED=0 python3 -m gmibench.calibrate --workload CELL \\
        --seeds 12 --faulted 3 [--first SEED] [--device cuda]

In one process: the program's first checked iterations against the
reference on ``--seeds`` seeds (the lower readings), then on the first
``--faulted`` of them the controls (the reference in TF32, and with only
its update in TF32) and each fault the cell can have, planted in the
reference put in the program's place, against the same reference
readings (the upper readings).  On those seeds it also reads a witness:
the program and the float32 reference each against the reference in
float64 (``fp64.program``, ``fp64.reference``).  Prints one JSON line a
reading and a last line with, for each number and kind, the smallest and
the largest reading.  The window is not run: the checked iterations are
the ones a run compares.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seeds, faulted, device):
    """Yields (kind, seed, numbers) for every reading."""
    import torch
    from gmibench import compare
    from gmibench.runners import ppo_gmis as pg
    from gmibench.references import ppo_chain as ref
    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    prog = pg.build(cfg, traffic, dev)
    kinds = ["tf32", "tf32_update", "half_batch"] + (
        ["no_average"] if traffic["gmis"] > 1 else [])
    for j, seed in enumerate(seeds):
        inputs = pg.make_inputs(cfg, traffic, seed, dev)
        states = pg.program_states(prog, cfg, inputs)
        got = pg.checked(prog, states, inputs)
        del states
        want = ref.run(cfg, traffic, inputs, dev, pg.CHECKED)
        yield "program", seed, compare.gaps(got, want)
        if j >= faulted:
            continue
        for kind in kinds:
            fault = kind if kind in ref.FAULTS else None
            other = ref.run(cfg, traffic, inputs, dev, pg.CHECKED,
                            precision="fp32" if fault else kind,
                            fault=fault)
            yield kind, seed, compare.gaps(other, want)
        truth = ref.run(cfg, traffic, inputs, dev, pg.CHECKED,
                        precision="fp64")
        yield "fp64.program", seed, compare.gaps(got, truth)
        yield "fp64.reference", seed, compare.gaps(want, truth)


def summary(rows):
    """Per number and kind: [smallest, largest] reading."""
    out = {}
    for kind, _, nums in rows:
        for k, v in nums.items():
            v = float("inf") if v is None else v
            lo, hi = out.setdefault(k, {}).get(kind, [v, v])
            out[k][kind] = [min(lo, v), max(hi, v)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--faulted", type=int, default=3)
    ap.add_argument("--first", type=int, default=3_000_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if os.environ.get("PYTHONHASHSEED") != "0":
        print("gmibench.calibrate: run under PYTHONHASHSEED=0",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from gmibench import spec
    cell = spec.load(args.workload)
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    rows = []
    for kind, seed, nums in readings(cell, seeds, args.faulted,
                                     args.device):
        rows.append((kind, seed, nums))
        print(json.dumps({"cell": args.workload, "kind": kind,
                          "seed": seed, **nums}), flush=True)
    print(json.dumps({"cell": args.workload, "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
