"""Op accounting for the roofline (port of ``repro/launch/hlo_analysis.py``).

The reference parses a compiled step's HLO.  The port has no HLO: its
program is the sequence of aten ops that a step dispatches, and eager
execution runs each as a kernel of its own.  :class:`OpCounter`, a
``TorchDispatchMode``, records that sequence as a trace: each op's name,
its argument and result shapes and dtypes, the storages it allocates and
those freed since the op before, and each call of a hand-written kernel
that a fake tensor stood in for (``kernels/ops.py``).  :func:`analyze`
computes every count from the trace alone, so a saved trace
(:func:`save_trace`) can be counted again (``launch/reanalyze.py``):

* ``dot_flops``        — 2 * prod(result) * contraction size of every
                         matrix product (mm, addmm, bmm, baddbmm, addbmm,
                         mv, addmv, dot)
* ``traffic_bytes``    — argument + result bytes of every op that is not a
                         view, metadata or allocation op: the card's
                         unfused traffic, kernels' own excluded
* ``collective_bytes`` — result bytes of c10d and functional collectives,
                         also by op (``coll_by_op``, ``coll_counts``); 0 on
                         one card, as is ``cross_pod_bytes``
* ``kernel_flops`` / ``kernel_bytes`` — by kernel name, each hand-written
                         kernel call's operations and bytes
                         (``kernels/cost.py``): the aten counts do not see
                         inside a kernel
* memory               — ``mem_argument_bytes`` (the distinct storages of
                         the step's arguments), ``mem_output_bytes``,
                         ``mem_alias_bytes`` (outputs that are argument
                         storages: in-place cache writes) and
                         ``mem_temp_bytes``, the peak of live bytes above
                         the arguments, each storage followed from the op
                         that allocates it until it is freed

Known limitations: non-dot FLOPs are not counted, as in the reference;
allocations inside one aten kernel (a library's workspace) are not seen.
"""
from __future__ import annotations

import gzip
import json
import re
import time
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.utils import tree_leaves, tree_map

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "f8e4m3": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "s4": 1, "u4": 1, "pred": 1, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

_TORCH_DTYPES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2", torch.int64: "s64", torch.uint64: "u64",
    torch.int32: "s32", torch.uint32: "u32", torch.int16: "s16",
    torch.uint16: "u16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}

_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")

# contraction size of a matrix product from its argument dims
_CONTRACTIONS = {
    "aten.mm": lambda a: a[0][-1], "aten.bmm": lambda a: a[0][-1],
    "aten.addmm": lambda a: a[1][-1], "aten.baddbmm": lambda a: a[1][-1],
    "aten.addbmm": lambda a: a[1][0] * a[1][-1],
    "aten.mv": lambda a: a[0][-1], "aten.addmv": lambda a: a[1][-1],
    "aten.dot": lambda a: a[0][0], "aten.vdot": lambda a: a[0][0],
}

# ops that allocate or relabel without moving data
_FREE_OPS = {"aten.empty", "aten.empty_strided", "aten.empty_like",
             "aten.new_empty", "aten.new_empty_strided", "aten.detach",
             "aten.alias", "aten._unsafe_view", "aten.lift_fresh",
             "aten.set_", "aten.resize_"}

_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _shapes(text: str):
    out = []
    for dt, dims in _SHAPE_RE.findall(text):
        if dt in DTYPE_BYTES:
            out.append((dt, [int(d) for d in dims.split(",") if d]))
    return out


def _nbytes(text: str) -> int:
    total = 0
    for dt, dims in _shapes(text):
        n = 1
        for d in dims:
            n *= d
        total += n * DTYPE_BYTES[dt]
    return total


def spec(t: torch.Tensor) -> str:
    """A tensor's dtype and shape as the reference's HLO writes them."""
    return f"{_TORCH_DTYPES.get(t.dtype, 'opaque')}[" \
        f"{','.join(str(d) for d in t.shape)}]"


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Records the aten ops dispatched under it as a trace (see the module
    docstring).  ``card=True`` says that fake CPU tensors under it stand
    for the card, so the kernel wrappers record their kernels in place of
    the plain versions.  Use :meth:`watch` on the step's arguments before
    the step and :meth:`finish` on its outputs after it."""

    def __init__(self, card: bool = False):
        super().__init__()
        self.card = card
        self.events: List[list] = []
        self.args: List[list] = []
        self.outputs: List[list] = []
        self._ids: Dict[int, int] = {}    # id(storage) -> trace id
        self._sizes: Dict[int, int] = {}  # trace id -> bytes
        self._freed: List[int] = []
        self._next = 0
        self._arg_ids: Dict[int, list] = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        ops.TRACERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.TRACERS.remove(self)
        return super().__exit__(*exc)

    # -- storages ------------------------------------------------------
    def _on_free(self, key: int, tid: int):
        if self._ids.get(key) == tid:
            del self._ids[key]
        self._freed.append(tid)

    def _track(self, st) -> tuple:
        """(trace id, is new) of a storage; a new one is followed until
        it is freed."""
        key = id(st)
        tid = self._ids.get(key)
        if tid is not None:
            return tid, False
        tid = self._next
        self._next += 1
        self._ids[key] = tid
        self._sizes[tid] = st.nbytes()
        weakref.finalize(st, self._on_free, key, tid)
        return tid, True

    def watch(self, args) -> None:
        for t in _tensors(args):
            tid, new = self._track(t.untyped_storage())
            if new:
                self.args.append([tid, self._sizes[tid], 0])
                self._arg_ids[tid] = self.args[-1]

    def finish(self, outputs) -> None:
        seen = set()
        for t in _tensors(outputs):
            tid, _ = self._track(t.untyped_storage())
            if tid not in seen:
                seen.add(tid)
                self.outputs.append([tid, self._sizes[tid]])

    # -- ops -----------------------------------------------------------
    def record_kernel(self, name: str, flops, nbytes) -> None:
        self.events.append(["kernel", name, int(flops), int(nbytes)])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":      # metadata queries
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {id(t.untyped_storage()) for t in ins}
        for key in in_keys:
            arg = self._arg_ids.get(self._ids.get(key))
            if arg is not None:
                arg[2] = 1
        frees, self._freed = self._freed, []
        allocs = []
        for t in outs:
            st = t.untyped_storage()
            if id(st) in in_keys:
                continue
            tid, new = self._track(st)
            if new:
                allocs.append([tid, self._sizes[tid]])
        name = str(func.overloadpacket)
        view = bool(getattr(func, "is_view", False))
        self.events.append(["op", name, [spec(t) for t in ins],
                            [spec(t) for t in outs], allocs, frees,
                            int(view)])
        return out

    def trace(self) -> dict:
        return {"args": self.args, "events": self.events,
                "outputs": self.outputs}


def analyze(trace: dict) -> Dict:
    """Every count of a trace (see the module docstring)."""
    dot = traffic = coll = 0.0
    coll_by_op: Dict[str, float] = {}
    coll_counts: Dict[str, int] = {}
    kflops: Dict[str, int] = {}
    kbytes: Dict[str, int] = {}
    kcalls: Dict[str, int] = {}
    # an argument no op reads is not one (jit drops it too)
    args = {tid: b for tid, b, used in trace["args"] if used}
    sizes: Dict[int, int] = {}
    live = peak = 0
    n_ops = 0
    for ev in trace["events"]:
        if ev[0] == "kernel":
            _, name, fl, nb = ev
            kflops[name] = kflops.get(name, 0) + fl
            kbytes[name] = kbytes.get(name, 0) + nb
            kcalls[name] = kcalls.get(name, 0) + 1
            continue
        _, name, ins, outs, allocs, frees, view = ev
        n_ops += 1
        for tid in frees:
            live -= sizes.pop(tid, 0)
        for tid, b in allocs:
            sizes[tid] = b
            live += b
        peak = max(peak, live)
        if not view and name not in _FREE_OPS:
            traffic += sum(_nbytes(s) for s in ins + outs)
        k = _CONTRACTIONS.get(name)
        if k is not None:
            dims = [_shapes(s)[0][1] for s in ins]
            res = 1
            for d in _shapes(outs[0])[0][1]:
                res *= d
            dot += 2.0 * res * k(dims)
        ns, _, op = name.partition(".")
        if ns in _COLL_NAMESPACES and op in _COLLECTIVES:
            base = _COLLECTIVES[op]
            b = sum(_nbytes(s) for s in outs)
            coll += b
            coll_by_op[base] = coll_by_op.get(base, 0.0) + b
            coll_counts[base] = coll_counts.get(base, 0) + 1
    out_ids = {tid: b for tid, b in trace["outputs"]}
    return {
        "dot_flops": dot, "traffic_bytes": traffic,
        "collective_bytes": coll, "cross_pod_bytes": 0.0,
        "coll_by_op": coll_by_op, "coll_counts": coll_counts,
        "kernel_flops": kflops, "kernel_bytes": kbytes,
        "kernel_calls": kcalls, "n_ops": n_ops,
        "mem_argument_bytes": sum(args.values()),
        "mem_output_bytes": sum(out_ids.values()),
        "mem_alias_bytes": sum(b for tid, b in out_ids.items()
                               if tid in args),
        "mem_temp_bytes": peak,
    }


def save_trace(trace: dict, path: str) -> None:
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)


def load_trace(path: str) -> dict:
    with gzip.open(path, "rt") as f:
        return json.load(f)


def fake_device(device: str) -> tuple:
    """(the device fake tensors live on, whether they stand for the card)
    for a trace of ``device``: ``"cuda"`` is the card's program, on fake
    CUDA tensors where PyTorch is built with CUDA, else on fake CPU
    tensors marked as the card's (such a build cannot run autograd on
    fake CUDA tensors); ``"cpu"`` the plain versions."""
    if device == "cpu":
        return "cpu", False
    if device != "cuda":
        raise ValueError(f"trace device must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    return ("cuda" if torch.backends.cuda.is_built() else "cpu"), True


def trace(fn, args, device: str = "cuda") -> dict:
    """Run ``fn(*args)`` once on fake tensors: every meta leaf of ``args``
    becomes a fake tensor of its shape and dtype on the trace's device
    (:func:`fake_device`), every real one a fake tensor on its own device
    that shares a storage where the real ones do.  Returns the op
    counter's trace, ``analyze``'s counts under ``"counts"``,
    ``FlopCounterMode``'s total under ``"flop_counter"`` (its own
    definition of a FLOP) and the seconds the trace took."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    dev, card = fake_device(device)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        def fake(x):
            if not isinstance(x, torch.Tensor):
                return x
            if x.is_meta:
                return torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                           dtype=x.dtype, device=dev)
            return mode.from_tensor(x)      # keeps shared storages shared
        fargs = tree_map(fake, args)
        flops = FlopCounterMode(display=False)
        counter = OpCounter(card=card)
        counter.watch(fargs)
        with flops, counter:
            out = fn(*fargs)
        counter.finish(out)
        del out
    tr = counter.trace()
    return {"trace": tr, "counts": analyze(tr),
            "flop_counter": flops.get_total_flops(),
            "seconds": time.perf_counter() - t0}
