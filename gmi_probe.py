#!/usr/bin/env python3
"""Probe what an NVIDIA card offers a GMI beyond CUDA streams: MIG mode
and whether ``nvidia-smi mig -lgip`` lists GPU-instance profiles, whether
an MPS control daemon starts as this user (it is asked to quit at once,
in a private pipe directory), whether the installed PyTorch exposes
CUDA green contexts (tried in a child process), and how the card splits
its SMs into GMI slots with the port's own driver calls, in both split
modes, with the cuBLAS GEMMs that fail in a slot of each (child
processes; the kernels are built from ``src/``).  Prints one line a
fact; asserts only that a daemon it started has quit.

    python3 gmi_probe.py

Needs one CUDA card and ``nvcc``.  The answers decided how a GMI's
``resource_fraction`` is carved (``repro_torch.core.gmi``: green
contexts from splits that keep clusters' SMs together); the training
path does not need this script.
"""
from __future__ import annotations

import os
import subprocess
import sys

import torch


def probe_gmi_backends():
    """What the card offers beyond streams for a GMI's resource share: MIG mode and whether ``nvidia-smi mig -lgip`` lists
    profiles, whether an MPS control daemon starts as this user (it is
    asked to quit at once, in a private pipe directory), and whether this
    PyTorch exposes CUDA green contexts."""
    import shutil
    import tempfile
    lines = []
    q = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True,
                       timeout=60).stdout.splitlines()
    mig = [ln.strip() for i, ln in enumerate(q) if "MIG Mode" in ln
           for ln in q[i:i + 3]]
    lines.append(f"[probe] nvidia-smi -q MIG: {mig}")
    r = subprocess.run(["nvidia-smi", "mig", "-lgip"], capture_output=True,
                       text=True, timeout=60)
    lines.append(f"[probe] nvidia-smi mig -lgip: rc {r.returncode}")
    lines += [f"[probe]   {ln}" for ln in
              (r.stdout + r.stderr).strip().splitlines()]
    mps = shutil.which("nvidia-cuda-mps-control")
    if mps is None:
        lines.append("[probe] nvidia-cuda-mps-control: not on PATH")
    else:
        with tempfile.TemporaryDirectory() as d:
            env = dict(os.environ, CUDA_MPS_PIPE_DIRECTORY=f"{d}/pipe",
                       CUDA_MPS_LOG_DIRECTORY=f"{d}/log")
            os.makedirs(f"{d}/pipe")
            os.makedirs(f"{d}/log")
            r = subprocess.run([mps, "-d"], capture_output=True, text=True,
                               timeout=60, env=env)
            msg = f"-d rc {r.returncode} {(r.stdout + r.stderr).strip()!r}"
            if r.returncode == 0:
                q = subprocess.run([mps], input="quit\n", capture_output=True,
                                   text=True, timeout=60, env=env)
                msg += f", quit rc {q.returncode}"
                assert q.returncode == 0, ("MPS daemon did not quit", msg)
            lines.append(f"[probe] {mps}: {msg}")
    # a green context carves SMs for the streams made under it; tried in
    # a child process, so that the probe leaves this one's context alone
    code = ("import inspect, torch\n"
            "gc = getattr(torch.cuda, 'green_contexts', None)\n"
            "print('module', gc is not None)\n"
            "G = gc.GreenContext\n"
            "print('SUPPORTED', getattr(gc, 'SUPPORTED', None))\n"
            "print('create', inspect.signature(G.create))\n"
            "ctx = G.create(num_sms=32, device_id=0)\n"
            "print('created', [m for m in dir(ctx) if m[0] != '_'])\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    lines.append(f"[probe] CUDA green contexts (child process): rc "
                 f"{r.returncode}")
    lines += [f"[probe]   {ln}" for ln in
              (r.stdout + r.stderr).strip().splitlines()[-8:]]
    return lines


# the card's SM splits tried (slots of floor(SMs / n / 8) * 8 SMs) and the
# GEMMs (M, K, N) run in a green context of one slot of each
SPLIT_SLOTS = (2, 4, 10, 15, 16)
SPLIT_GEMMS = [(m, k, n) for m in (1, 8, 64, 896) for k, n in
               ((2048, 2048), (2048, 8192), (8192, 2048))]
_SPLIT_CODE = """
import sys, torch
sys.path.insert(0, {src!r})
from repro_torch.core import sm_partition as smp
per_sm, warm, slots, gemms = {per_sm}, {warm}, {slots}, {gemms}
dev = torch.device("cuda", 0)
sms = torch.cuda.get_device_properties(dev).multi_processor_count
if not per_sm:
    print("granularity", smp.granularity(0))
for dt in (torch.bfloat16, torch.float32):
    for m, k, c in gemms if warm else ():
        torch.randn(m, k, device=dev, dtype=dt) @ torch.randn(
            k, c, device=dev, dtype=dt)
for n in slots:
    w = sms // n // 8 * 8
    if per_sm:
        gran, made, ctx, st, got = smp.diag_per_sm_context(0, n, w)
        if n == slots[0]:
            print("granularity", gran)
    else:
        made = len(smp.split(0, n, w))
        if made == n:
            ctx, st, got = smp.create(0, n, w, [0])
    if made < n:
        print(f"{{n}} x {{w}}: the split made {{made}} groups")
        continue
    stream = torch.cuda.ExternalStream(st, device=dev)
    failed = []
    for dt in (torch.bfloat16, torch.float32):
        for m, k, c in gemms:
            a = torch.randn(m, k, device=dev, dtype=dt)
            b = torch.randn(k, c, device=dev, dtype=dt)
            torch.cuda.synchronize()
            smp.push(ctx)
            try:
                with torch.cuda.stream(stream):
                    stream.wait_stream(torch.cuda.default_stream(dev))
                    a @ b
                stream.synchronize()
            except RuntimeError:
                failed.append((str(dt)[6:], m, k, c))
            finally:
                smp.pop(ctx)
    print(f"{{n}} x {{w}}: {{made}} groups, a context of one holds "
          f"{{got}} SMs; GEMMs failed in it: {{failed or 'none'}} of "
          f"{{2 * len(gemms)}}")
"""


def probe_green_splits():
    """How the card splits its SMs into GMI slots (``repro_torch.core.
    sm_partition``), each split mode in child processes: keeping the SMs
    a thread-block cluster spans together (what GMIs use) and treating
    each SM on its own (``diag_per_sm_context``, this probe's alone): the
    granularity, the groups each of SPLIT_SLOTS makes, and which bf16 and
    f32 cuBLAS GEMMs of SPLIT_GEMMS fail in a green context of one slot,
    in a process whose cuBLAS ran them on the whole card first (as every
    real run's has, PyTorch keeping one cuBLAS handle a device and thread)
    and in one where it did not."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    lines = []
    for per_sm, warm in ((False, True), (True, True), (False, False),
                         (True, False)):
        r = subprocess.run(
            [sys.executable, "-c", _SPLIT_CODE.format(
                src=src, per_sm=per_sm, warm=warm, slots=SPLIT_SLOTS,
                gemms=SPLIT_GEMMS)],
            capture_output=True, text=True, timeout=600)
        mode = "each SM on its own" if per_sm else "clusters' SMs together"
        lines.append(f"[probe] SM split keeping {mode}, the GEMMs run on "
                     f"the whole card first: {warm} (child process): rc "
                     f"{r.returncode}")
        lines += [f"[probe]   {ln}" for ln in
                  (r.stdout + r.stderr).strip().splitlines()[-12:]]
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("gmi_probe: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for line in probe_gmi_backends() + probe_green_splits():
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
