"""What the benchmark reads from a ``torch.profiler`` trace of a few
iterations: the device's kernels, the benchmark's own host ranges and the
host's top-level operations, each as (name, start us, end us).  The
interval arithmetic and the kernel groups are copies of the port's
``launch/profile.py`` (``_union_us``, ``_group``)."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Tuple

# the benchmark's own profiler ranges start with this
RANGE_PREFIX = "gmibench."

Interval = Tuple[str, float, float]


def kernel_group(name: str) -> str:
    """The port's kernels by name, cuBLAS GEMMs, and the rest."""
    for key in ("env_mega_step", "fused_policy_mlp", "gae_",
                "paged_decode", "flash_attention", "mlstm_"):
        if key in name:
            return key.rstrip("_") + " (port kernel)"
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "nvjet" in low:
        return "GEMM (cuBLAS)"
    return "other"


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def concurrency(intervals) -> float:
    """Summed interval length over the union's: 1 where nothing overlaps,
    above 1 where intervals run at once; 0 for none."""
    u = union_us(intervals)
    return sum(e - s for s, e in intervals) / u if u else 0.0


def idle_gaps(intervals, start: float, end: float):
    """The gaps in ``[start, end]`` that no interval covers, as (start,
    end), in time order."""
    gaps, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [(a, b) for a, b in gaps if b > a]


@dataclass
class Trace:
    """A profiled stretch of ``iterations`` iterations, ``wall_us`` long by
    the host's clock, whose trace starts at ``start_us``: its ``kernels``,
    the host seconds of each GMI step (``step_s``, by the benchmark's own
    clock) and the longest idle gaps of a further iteration traced with
    the host's operations (``gaps``, :func:`named_gaps`)."""
    kernels: List[Interval]
    wall_us: float
    start_us: float
    iterations: int
    step_s: List[float]
    gaps: list

    def kernel_intervals(self, key: str = ""):
        return [(s, e) for n, s, e in self.kernels if key in n]

    def busy_us(self) -> float:
        return union_us(self.kernel_intervals())

    def top_kernels(self, top: int = 10):
        """[name, seconds] of the kernels that took the most device time."""
        by = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:160], us / 1e6] for n, us in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def named_gaps(kernels, ranges, host_ops, start: float, wall: float,
               top: int = 10):
    """[what the host was doing, seconds] of the longest stretches of
    ``[start, start + wall]`` in which no kernel ran: the innermost
    benchmark range and the host's top-level operation at the gap's
    start."""
    gaps = idle_gaps([(s, e) for _, s, e in kernels], start, start + wall)
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        rng = [(e - s, n) for n, s, e in ranges if s <= a < e]
        ops = [(s - e, n) for n, s, e in host_ops if s <= a < e]
        where = min(rng)[1][len(RANGE_PREFIX):] if rng else "no range"
        if ops:
            where += " > " + min(ops)[1]
        out.append([where, (b - a) / 1e6])
    return out


def profile(fn, host: bool):
    """Run ``fn`` (which ends with the device synchronised) under the
    profiler, with CUDA activity and, if ``host``, the host's operations
    (which slow the host: a stretch traced so is read only for what the
    host was doing).  Returns (wall us, kernels, benchmark ranges, host's
    top-level operations, the trace's start); a benchmark range leaves a
    device-side annotation too, which is no kernel."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kernels, ranges, ops = [], [], []
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        mine = e.name.startswith(RANGE_PREFIX)
        if e.device_type == cuda:
            if not mine:
                kernels.append(iv)
        elif mine:
            ranges.append(iv)
        elif e.cpu_parent is None or e.cpu_parent.name.startswith(
                RANGE_PREFIX):
            ops.append(iv)
    starts = [s for _, s, _ in kernels + ranges]
    return wall_us, kernels, ranges, ops, min(starts) if starts else 0.0
