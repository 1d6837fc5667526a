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
                         one card
* ``cross_pod_bytes``  — those of them whose process group spans the
                         ``pod`` mesh axis (the reference's
                         ``crosses_pod``)
* ``plain_fwd_dot_flops`` — the part of ``dot_flops`` that a kernel's
                         plain forward computes: in the kernel's place on
                         the CPU, or as its backward's recompute on the card
                         (``kernels/ops.py::_plain_forward``); the rest is
                         the same program on both devices
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

A sharded step (DTensor arguments, ``launch/steps.py`` on a
``DeviceMesh``) is counted on one rank: the counter lets DTensor handle
each op and records the local ops and the functional collectives it
issues, with their local shapes.  DTensor's sharding propagation runs
ops of its own on fake tensors of its own; those are not the rank's
program and are left out, as are the collectives' ``wait_tensor`` and
``_wrap_tensor_autograd`` wrappers (no data moves).  On fake tensors
those wrappers return a result under a storage object of its own, where
a real wait returns its argument: the counter counts such a result as
its argument's storage, freed with the last of the two (counted apart,
a gathered buffer was counted twice, for as long as the trace held
either).  DTensor's all-to-all (``_dtensor.shard_dim_alltoall``, a split
moved from one dim to another) is a collective, counted at its result's
bytes as ``all_to_all_single`` is; some PyTorch versions' fake kernel
returns a view into the concatenation of every rank's input, and the
result is counted at its own bytes, as the card allocates it.  On a CPU
mesh DTensor runs that all-to-all as an all-gather of every rank's input,
the rank's chunk of it and a copy; the counter records those ops as the
card's one all-to-all, each buffer they make counted as its result, so a
rank's trace is the card's program whichever device traces it.  Under the ``fake``
process group (one process standing for one rank of a large mesh) the
collectives move nothing, so such a trace measures the rank's compute,
memory and the bytes it would move, not the time its communication takes.

Known limitations: non-dot FLOPs are not counted, as in the reference;
allocations inside one aten kernel (a library's workspace) are not seen.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import re
import sys
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
             "aten.set_", "aten.resize_", "_c10d_functional.wait_tensor",
             "_c10d_functional._wrap_tensor_autograd"}

_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d",
                    "_dtensor")
_ALLTOALL = "_dtensor.shard_dim_alltoall"
# ops whose result is their argument's data under a storage object of its
# own on fake tensors (a real wait returns its argument): one allocation
_ALIAS_OPS = {"_c10d_functional.wait_tensor",
              "_c10d_functional._wrap_tensor_autograd"}
# ops whose fake result is a view into a buffer the group's size times
# larger (a concatenation of every rank's input), where the card's result
# is a buffer of its own: counted at the result's bytes
_RESULT_SIZED_OPS = {_ALLTOALL}
# an op event's optional eighth field: flags of what the op is
_POD = 1          # a collective whose group spans the pod axis
_PLAIN_FWD = 2    # inside a kernel's plain forward


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


def spec(t: torch.Tensor, shape=None) -> str:
    """A tensor's dtype and shape (or ``shape``) as the reference's HLO
    writes them."""
    return f"{_TORCH_DTYPES.get(t.dtype, 'opaque')}[" \
        f"{','.join(str(d) for d in (t.shape if shape is None else shape))}]"


def _tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of ``tree``, a DTensor as its local tensor."""
    from torch.distributed.tensor import DTensor
    return [x._local_tensor if isinstance(x, DTensor) else x
            for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _dtensor_caller() -> tuple:
    """What DTensor is doing where the op being dispatched comes from:
    ``(True, None)`` while its sharding propagator runs the op on fake
    global tensors of its own to learn an output's shape (not the rank's
    program); ``(False, frame)`` inside its all-to-all
    (``_collective_utils.shard_dim_alltoall``, that function's frame);
    else ``(False, None)``."""
    f, a2a = sys._getframe(2), None
    while f is not None:
        code = f.f_code
        if code.co_filename.endswith("_sharding_prop.py"):
            return True, None
        if a2a is None and code.co_name == "shard_dim_alltoall" and \
                code.co_filename.endswith("_collective_utils.py"):
            a2a = f
        f = f.f_back
    return False, a2a


def _group_name(args) -> str:
    """The process-group name a functional collective's arguments carry
    (its last string argument)."""
    for a in reversed(args):
        if isinstance(a, str):
            return a
    return ""


class OpCounter(TorchDispatchMode):
    """Records the aten ops dispatched under it as a trace (see the module
    docstring).  ``card=True`` says that fake CPU tensors under it stand
    for the card, so the kernel wrappers record their kernels in place of
    the plain versions.  Use :meth:`watch` on the step's arguments before
    the step and :meth:`finish` on its outputs after it."""

    def __init__(self, card: bool = False, fake_mode=None,
                 pod_groups=()):
        super().__init__()
        self.card = card
        # the fake mode whose tensors are the traced program's (None: a
        # run on real tensors); other fake tensors are DTensor's own
        self.fake_mode = fake_mode
        # names of the process groups that span the ``pod`` mesh axis
        self.pod_groups = set(pod_groups)
        # whether the program runs on DTensors (set by :meth:`watch`)
        self.sharded = False
        self.events: List[list] = []
        self.args: List[list] = []
        self.outputs: List[list] = []
        self._ids: Dict[int, int] = {}    # id(storage) -> trace id
        self._sizes: Dict[int, int] = {}  # trace id -> bytes
        self._refs: Dict[int, int] = {}   # trace id -> live storage objects
        self._freed: List[int] = []
        self._next = 0
        self._arg_ids: Dict[int, list] = {}
        self._a2a = None    # trace id of the CPU all-to-all's result
        # > 0 inside a kernel's plain forward (``ops._plain_forward``)
        self.plain_depth = 0
        # one string object a (dtype, shape): a long trace holds millions
        # of specs of a few shapes
        self._specs: Dict[tuple, str] = {}

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
        self._refs[tid] -= 1
        if not self._refs[tid]:
            self._freed.append(tid)

    def _follow(self, st, tid: int) -> None:
        """Count storage object ``st`` under ``tid`` until it is freed;
        ``tid`` is freed with the last of its objects."""
        key = id(st)
        self._ids[key] = tid
        self._refs[tid] = self._refs.get(tid, 0) + 1
        weakref.finalize(st, self._on_free, key, tid)

    def _track(self, st, nbytes=None) -> tuple:
        """(trace id, is new) of a storage; a new one (of ``nbytes``, or
        its own size) is followed until it is freed."""
        tid = self._ids.get(id(st))
        if tid is not None:
            return tid, False
        tid = self._next
        self._next += 1
        self._sizes[tid] = st.nbytes() if nbytes is None else nbytes
        self._follow(st, tid)
        return tid, True

    def watch(self, args) -> None:
        from torch.distributed.tensor import DTensor
        self.sharded = self.sharded or any(
            isinstance(x, DTensor) for x in tree_leaves(args))
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

    def _spec(self, t, shape=None) -> str:
        key = (t.dtype, tuple(t.shape if shape is None else shape))
        out = self._specs.get(key)
        if out is None:
            out = self._specs[key] = spec(t, shape)
        return out

    def _foreign(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return any(isinstance(t, FakeTensor) and t.fake_mode is not
                   self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs the op as local ops and collectives, which
            # come back here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":      # metadata queries
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        prop, a2a = _dtensor_caller() if self.sharded else (False, None)
        if self._foreign(ins) or self._foreign(outs) or prop or (
                (ins or outs) and all(t.is_meta for t in ins + outs)):
            return out
        name = str(func.overloadpacket)
        if a2a is not None and name != _ALLTOALL:
            self._alltoall_fallback(name, a2a, args, ins, outs)
            return out
        in_keys = self._read(ins)
        frees, self._freed = self._freed, []
        src = self._ids.get(id(ins[0].untyped_storage())) \
            if name in _ALIAS_OPS and ins else None
        allocs = []
        for t in outs:
            st = t.untyped_storage()
            if id(st) in in_keys:
                continue
            if src is not None and id(st) not in self._ids:
                self._follow(st, src)
                continue
            tid, new = self._track(
                st, t.numel() * t.element_size()
                if name in _RESULT_SIZED_OPS else None)
            if new:
                allocs.append([tid, self._sizes[tid]])
        view = bool(getattr(func, "is_view", False))
        ev = ["op", name, [self._spec(t) for t in ins],
              [self._spec(t) for t in outs], allocs, frees, int(view)]
        flags = (_POD if func.namespace in _COLL_NAMESPACES and
                 _group_name(args) in self.pod_groups else 0) | (
                     _PLAIN_FWD if self.plain_depth else 0)
        if flags:
            ev.append(flags)
        self.events.append(ev)
        return out

    def _read(self, ins) -> set:
        """The storages of an op's arguments; a step argument among them
        is one (see :func:`analyze`)."""
        in_keys = {id(t.untyped_storage()) for t in ins}
        for key in in_keys:
            arg = self._arg_ids.get(self._ids.get(key))
            if arg is not None:
                arg[2] = 1
        return in_keys

    def _alltoall_fallback(self, name, frame, args, ins, outs) -> None:
        """An op of DTensor's all-to-all on a CPU mesh, which gathers
        every rank's input, takes the rank's chunk of it and copies that
        (``frame``: the all-to-all's).  The all-gather is recorded as the
        card's ``_dtensor.shard_dim_alltoall`` of the same input, its
        result the rank's chunk, counted at the chunk's bytes; every
        buffer the later ops make is counted as that result (the card
        holds one buffer there)."""
        if name != "_c10d_functional.all_gather_into_tensor":
            for t in outs:
                st = t.untyped_storage()
                if id(st) not in self._ids:
                    self._follow(st, self._a2a)
            return
        self._read(ins)
        frees, self._freed = self._freed, []
        x = ins[0]
        shape = list(x.shape)
        n = outs[0].shape[0] // shape[0]
        loc = frame.f_locals
        shape[loc["gather_dim"]] *= n
        shape[loc["shard_dim"]] //= n
        nbytes = x.element_size()
        for d in shape:
            nbytes *= d
        self._a2a, _ = self._track(outs[0].untyped_storage(), nbytes)
        ev = ["op", _ALLTOALL, [self._spec(x)], [self._spec(x, shape)],
              [[self._a2a, nbytes]], frees, 0]
        if _group_name(args) in self.pod_groups:
            ev.append(_POD)
        self.events.append(ev)

    def trace(self) -> dict:
        return {"args": self.args, "events": self.events,
                "outputs": self.outputs}


def analyze(trace: dict) -> Dict:
    """Every count of a trace (see the module docstring)."""
    dot = plain = traffic = coll = pod = 0.0
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
        _, name, ins, outs, allocs, frees, view = ev[:7]
        flags = ev[7] if len(ev) > 7 else 0
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
            f = 2.0 * res * k(dims)
            dot += f
            if flags & _PLAIN_FWD:
                plain += f
        ns, _, op = name.partition(".")
        if ns in _COLL_NAMESPACES and op in _COLLECTIVES:
            base = _COLLECTIVES[op]
            b = sum(_nbytes(s) for s in outs)
            coll += b
            coll_by_op[base] = coll_by_op.get(base, 0.0) + b
            coll_counts[base] = coll_counts.get(base, 0) + 1
            if flags & _POD:
                pod += b
    out_ids = {tid: b for tid, b in trace["outputs"]}
    return {
        "dot_flops": dot, "plain_fwd_dot_flops": plain,
        "traffic_bytes": traffic,
        "collective_bytes": coll, "cross_pod_bytes": pod,
        "coll_by_op": coll_by_op, "coll_counts": coll_counts,
        "kernel_flops": kflops, "kernel_bytes": kbytes,
        "kernel_calls": kcalls, "n_ops": n_ops,
        "mem_argument_bytes": sum(args.values()),
        "mem_output_bytes": sum(out_ids.values()),
        "mem_alias_bytes": sum(b for tid, b in out_ids.items()
                               if tid in args),
        "mem_temp_bytes": peak,
    }


def live_at_peak(trace: dict) -> tuple:
    """What a trace holds at its peak of live bytes above the arguments
    (``analyze``'s ``mem_temp_bytes``): (the peak, ``[(bytes, op, result
    specs), ...]``), the bytes of every live buffer summed by the op and
    result specs that made it, largest first."""
    def replay(stop=None):
        sizes, live, peak, at = {}, 0, 0, -1
        for i, ev in enumerate(trace["events"]):
            if ev[0] != "op":
                continue
            for tid in ev[5]:
                live -= sizes.pop(tid, 0)
            for tid, b in ev[4]:
                sizes[tid] = b
                live += b
            if live > peak:
                peak, at = live, i
            if i == stop:
                break
        return peak, at, sizes
    peak, at, _ = replay()
    _, _, sizes = replay(at)
    made = {tid: (ev[1], tuple(ev[3])) for ev in trace["events"][:at + 1]
            if ev[0] == "op" for tid, _ in ev[4] if tid in sizes}
    held: Dict[tuple, int] = {}
    for tid, b in sizes.items():
        held[made[tid]] = held.get(made[tid], 0) + b
    return peak, sorted(((b, op, outs) for (op, outs), b in held.items()),
                        reverse=True)


def dot_redundancy(whole: dict, rank: dict, chips: int):
    """How many times over ``chips`` ranks compute the whole step's
    products, from the counts of the whole step and of one rank's program
    (1.0: no product is computed twice).  Taken over the products outside
    the kernels' forwards (``plain_fwd_dot_flops`` left out), which both
    devices compute alike: a kernel's forward is its kernel on the card
    and its plain version on the CPU, and those are counted apart
    (``kernel_flops``, a cost formula; ``dot_flops``, the plain route's
    full products).  None for a step without products."""
    base = whole["dot_flops"] - whole["plain_fwd_dot_flops"]
    return ((rank["dot_flops"] - rank["plain_fwd_dot_flops"]) * chips / base
            if base else None)


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


def pod_groups(dmesh) -> tuple:
    """Names of the process groups of ``dmesh`` that span its ``pod``
    axis (none without one)."""
    if dmesh is None or "pod" not in dmesh.mesh_dim_names:
        return ()
    return (dmesh.get_group("pod").group_name,)


def trace(fn, args, device: str = "cuda", place=None, dmesh=None) -> dict:
    """Run ``fn(*args)`` once on fake tensors: every meta leaf of ``args``
    becomes a fake tensor of its shape and dtype on the trace's device
    (:func:`fake_device`), every real one a fake tensor on its own device
    that shares a storage where the real ones do.  ``place`` (a sharded
    step on the ``DeviceMesh`` ``dmesh``) turns those arguments into the
    DTensors the step takes, the rank's shards fake, and the trace is
    then the rank's program.  Returns the op counter's trace,
    ``analyze``'s counts under ``"counts"``, ``FlopCounterMode``'s total
    under ``"flop_counter"`` (its own definition of a FLOP; None for a
    rank's program, where it would see DTensor's global shapes) and the
    seconds the trace took."""
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
        if place is None:
            fargs = tree_map(fake, args)
            flops = FlopCounterMode(display=False)
        else:
            fargs = place(args, dev)
            flops = contextlib.nullcontext()
        counter = OpCounter(card=card, fake_mode=mode,
                            pod_groups=pod_groups(dmesh))
        counter.watch(fargs)
        with flops, counter:
            out = fn(*fargs)
        counter.finish(out)
        del out
    tr = counter.trace()
    return {"trace": tr, "counts": analyze(tr),
            "flop_counter": None if place is not None
            else flops.get_total_flops(),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    # python -m repro_torch.launch.hlo_analysis TRACE [N]: a saved trace's
    # peak of live bytes and the N largest groups of what it holds there
    path, top = sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 10
    peak, held = live_at_peak(load_trace(path))
    print(f"peak live bytes above the arguments: {peak:,}")
    for b, op, outs in held[:top]:
        print(f"{b:>20,}  {op} -> {', '.join(outs)}")
