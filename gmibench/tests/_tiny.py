"""Shared helpers of the benchmark's CPU tests: a cell cut to a size the
CPU runs in seconds (2 GMIs x 8 envs), and a run of it on the CPU."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2 ** 31 + 977


def tiny(cell_name: str, gmis: int = 2, envs: int = 8):
    from gmibench import spec
    cell = spec.load(cell_name)
    return cell._replace(traffic=dict(cell.traffic, gmis=gmis,
                                      envs_per_gmi=envs))


def run_cpu(cell, seed: int = SEED) -> dict:
    """A whole run of ``cell`` on the CPU, its window cut to 0.1 s."""
    from gmibench import run
    return run.measure(cell, seed, 0.1, False, "cpu", time.perf_counter())
