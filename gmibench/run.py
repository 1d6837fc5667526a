"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    env PYTHONHASHSEED=0 python3 -m gmibench.run --workload CELL \\
        --seed N --seconds S --trace 0|1

from the root of a checkout.  It runs cell ``CELL`` of ``BENCHMARK.json``
on one process and the cards the cell asks for, measures for ``S``
seconds, checks what the timed path produced against the plain reference
and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit, which also close standard error.  It refuses to run (exit 2,
nothing printed) without the cards, or without ``PYTHONHASHSEED=0`` (the
envs seed their sensors from Python's ``hash``), and refuses to print
(exit 3) if JAX or the JAX package got loaded.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# whole top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    tops = {m.split(".")[0] for m in (sys.modules if modules is None
                                      else modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit_w():
    """The card's power limit in W by ``nvidia-smi``; None if unread."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t0: float) -> dict:
    """One run of ``cell`` (``spec.Cell``) on ``device``: its result line
    as a dict, ``checks`` last."""
    import torch
    from gmibench import compare, spec
    dev = torch.device(device)
    res = spec.runner(cell).run(cell, seed, seconds, trace, dev, t0)
    numbers = compare.gaps(res["readings"], res["reference"])
    correct, checks = compare.judge(numbers, cell.limits)
    if trace:
        ctx = spec.Context(cell.config, cell.traffic, res["window"],
                           res["trace"])
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    cuda = dev.type == "cuda"
    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": cell.entry["chips"],
            "memory_peak_bytes": res["memory_peak_bytes"],
            "power_limit_w": power_limit_w() if cuda else None}
    line = {"correct": correct and res["failed"] == 0,
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": info}
    if trace:
        t = res["trace"]
        info["busy_s"] = t.busy_us() / 1e6
        info["window_s"] = t.wall_us / 1e6
        line["breakdown"] = {"device_ops": t.top_kernels(),
                             "idle_gaps": t.gaps}
    line["checks"] = checks
    print("gmibench: seconds by phase " + json.dumps(res["phases_s"]),
          file=sys.stderr)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if os.environ.get("PYTHONHASHSEED") != "0":
        print("gmibench: run under PYTHONHASHSEED=0 (the envs seed their "
              "sensors from Python's hash)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from gmibench import spec
    cell = spec.load(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gmibench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   _T0)
    found = forbidden_modules()
    if found:
        print(f"gmibench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
