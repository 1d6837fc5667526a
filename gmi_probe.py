#!/usr/bin/env python3
"""Probe what an NVIDIA card offers a GMI beyond CUDA streams: MIG mode
and whether ``nvidia-smi mig -lgip`` lists GPU-instance profiles, whether
an MPS control daemon starts as this user (it is asked to quit at once,
in a private pipe directory) and whether the installed PyTorch exposes
CUDA green contexts (tried in a child process).  Prints one line a fact;
asserts only that a daemon it started has quit.

    python3 gmi_probe.py

Needs one CUDA card.  The answers decide which backend can carve a GMI's
``resource_fraction`` (``repro_torch.core.gmi``); the training path runs
on streams and does not need this script.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("gmi_probe: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for line in probe_gmi_backends():
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
