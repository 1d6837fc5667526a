"""Build and load the hand-written CUDA kernels.

Each ``repro_torch/csrc/*.cu`` file has a plain C interface and compiles
with ``nvcc`` into its own shared library, linked with the CUDA driver API
(``-lcuda``) and loaded with ``ctypes``.  All
sources compile at once, one ``nvcc`` process each, at the first CUDA use.
Libraries go to ``build/repro_torch_kernels/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads at once.  No ``--use_fast_math``:
``logf``, ``cosf`` and ``tanhf`` stay IEEE-accurate.  A missing ``nvcc``
or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# linked after each source: the CUDA driver API (green contexts, a
# context's SMs)
NVCC_LIBS = ["-lcuda"]

_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(add the CUDA toolkit's bin/ to PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LIBS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every source that has no library yet, all in parallel.
    Returns the seconds spent; raises with nvcc's output on a failure."""
    out_dir = build_dir()
    todo = [s for s in _sources()
            if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()  # repro: allow(host-sync-in-hot-path)
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        log = open(out_dir / f"{src.stem}.log", "w")
        procs.append((src, tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src),
             *NVCC_LIBS],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name} (rc {rc}):\n"
                          + (out_dir / f"{src.stem}.log").read_text())
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0  # repro: allow(host-sync-in-hot-path)


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    lib = _libs.get(stem)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(build_dir() / f"lib{stem}.so"))
        _libs[stem] = lib
    return lib


def check_tensor(op: str, name: str, x, shape, dtype=torch.float32):
    """Refuse what a kernel does not take: it reads raw pointers, so every
    operand must be a contiguous CUDA tensor of the exact shape and type."""
    if not x.is_cuda or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(
            f"{op}: {name} must be a contiguous CUDA {dtype} tensor of shape "
            f"{tuple(shape)}; got {x.dtype} {tuple(x.shape)} on {x.device}")


def build_logs() -> dict:
    """nvcc's ``-Xptxas -v`` output per source (registers, shared memory,
    spills), for the record."""
    d = build_dir()
    return {s.stem: (d / f"{s.stem}.log").read_text()
            for s in _sources() if (d / f"{s.stem}.log").exists()}
