"""GMI — GPU Multiplexing Instance (paper §3), port of
``repro/core/gmi.py``.

A GMI is a named, resource-budgeted instance assigned to one DRL role.
Device ids stay logical, as in the reference's launcher: a GMI owns
``round(devices_per_gpu * resource_fraction)`` ids of its GPU's pool, and
the manager checks overcommit, rectangular layouts and uniform device
counts on those ids.  The manager also holds one ``torch.device``, the
card every GMI of this process runs on.

On the card a logical device is a slot of the card's SMs: the SMs split
into ``devices_per_gpu`` equal slots of ``w = floor(SMs / devices_per_gpu
/ g) * g`` SMs, ``g`` the partition granularity of the card's compute
capability (8 SMs on sm_90, read on the card: 2 slots of 64 SMs on an
NVIDIA H100 80GB HBM3's 132 at 700 W, 4 of 32, 15 of 8; what the
rounding leaves is used by no GMI), and a GMI owns the union of its ids'
slots (:func:`sm_partition`).  Its work runs in a CUDA green context of
exactly those SMs, on that context's stream (:class:`GMIContext`): hand
kernels and cuBLAS alike.  A GMI that owns every slot of its pool, or
any GMI of a pool of one slot, runs on the whole card with a stream of
its own and no green context.  A slot narrower than ``g``, a split the
card cannot make (16 slots of 8 SMs on an H100, :func:`green_context`)
or a context that cannot be made raises: nothing carries on over the
whole card.  All logical GPUs of the process map onto the manager's one
card, so GMIs of different logical GPUs that own the same slots share
those SMs (and their stream).

The two backends of the reference map like this:

* ``axis``    (MPS-like): :meth:`GMIManager.instance_mesh` returns an
  :class:`InstanceGrid`, the (gpu, inst[, dev]) grid of a role with one
  :class:`GMIContext` per GMI on the card.  The LGR schedules of
  ``repro_torch.comm`` reduce grid-stacked tensors over it.
* ``submesh`` (MIG-like): :meth:`GMIManager.submesh` returns one GMI's own
  :class:`GMIContext`; such GMIs reduce only through the host
  (``comm.mpr_host``).

``GMIManager`` mirrors Listing 1's ``GMI_DRL.GMI_manager``: registration,
device attachment, communication groups.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils import resolve_device


@dataclass
class GMI:
    gmi_id: int
    role: str               # "simulator" | "agent" | "trainer" | "holistic"
    device_ids: List[int]           # logical device indices owned
    gpu_id: int                     # which physical device group (paper: GPU)
    backend: str = "axis"           # "axis" | "submesh"
    resource_fraction: float = 1.0  # paper: SM fraction / MIG slice size
    group: Optional[str] = None

    @property
    def num_devices(self) -> int:
        return len(self.device_ids)


class PartitionError(ValueError):
    """A share of the card's SMs that cannot be carved: slots narrower
    than the partition granularity, or a split the card cannot make.
    Algorithm 2's profiler counts such a layout as not runnable."""


# SMs a green context's partition is a multiple of, by compute capability
# major (CUDA's cuDevSmResourceSplitByCount: at least 8, in multiples of
# 8, on sm_90)
SM_GRANULARITY = {9: 8}


@dataclass(frozen=True)
class SMPartition:
    """A GMI's share of its card's SMs: ``slots`` (indices into its GPU's
    pool of ``num_slots`` slots of ``slot_sms`` SMs each; empty for the
    whole card, where ``slot_sms`` may be below ``granularity``) of a card
    of ``card_sms`` SMs, split at ``granularity``."""
    slots: Tuple[int, ...]
    num_slots: int
    slot_sms: int
    card_sms: int
    granularity: int

    @property
    def whole(self) -> bool:
        return not self.slots

    @property
    def sms(self) -> int:
        return self.card_sms if self.whole else len(self.slots) * \
            self.slot_sms

    @property
    def ranges(self) -> Tuple[Tuple[int, int], ...]:
        """The slots' logical SM ranges [start, stop); the card picks
        which physical SMs each slot holds."""
        if self.whole:
            return ((0, self.card_sms),)
        return tuple((s * self.slot_sms, (s + 1) * self.slot_sms)
                     for s in self.slots)

    @property
    def unused(self) -> int:
        """SMs of the card that no slot holds (the split's rounding); 0
        for the whole card."""
        return 0 if self.whole else \
            self.card_sms - self.num_slots * self.slot_sms


def sm_partition(gmi: GMI, devices_per_gpu: int, card_sms: int,
                 granularity: int) -> SMPartition:
    """The SMs GMI ``gmi`` owns on a card of ``card_sms`` SMs: logical
    device ``d`` of GPU ``gpu_id`` is slot ``d - gpu_id * devices_per_gpu``
    of ``devices_per_gpu`` slots of ``floor(card_sms / devices_per_gpu /
    granularity) * granularity`` SMs.  The whole card for a GMI that owns
    every slot, or a pool of one."""
    if not gmi.device_ids:
        raise ValueError(f"GMI {gmi.gmi_id} has no devices attached "
                         "(set_gpu not called)")
    slots = tuple(sorted(d - gmi.gpu_id * devices_per_gpu
                         for d in gmi.device_ids))
    if any(not 0 <= s < devices_per_gpu for s in slots):
        raise ValueError(f"GMI {gmi.gmi_id}: devices {gmi.device_ids} are "
                         f"not all in GPU {gmi.gpu_id}'s pool")
    width = card_sms // devices_per_gpu // granularity * granularity
    if len(slots) == devices_per_gpu:
        return SMPartition((), devices_per_gpu, width, card_sms,
                           granularity)
    if width < granularity:
        raise PartitionError(
            f"GMI {gmi.gmi_id}: {devices_per_gpu} slots of a card of "
            f"{card_sms} SMs are narrower than the {granularity}-SM "
            "partition granularity")
    return SMPartition(slots, devices_per_gpu, width, card_sms, granularity)


@dataclass(frozen=True)
class GreenContext:
    """A CUDA green context of one partition: the context and its stream
    (``core/sm_partition.py``); made once a (card, split, slots) and kept
    for the process."""
    ctx: int
    stream: torch.cuda.ExternalStream


_GREEN: Dict[tuple, GreenContext] = {}


def green_context(dev: torch.device, part: SMPartition) -> GreenContext:
    """The green context of ``part`` on card ``dev``, from one split of the
    card into ``part.num_slots`` groups of ``part.slot_sms`` SMs that keep
    the SMs a thread-block cluster may span together (in a split that
    treats each SM on its own, cuBLAS's bf16 GEMMs fail once the process
    has run them on the whole card, as every process has: ``gmi_probe.py``).
    Raises where the card cannot make those groups (an H100's GPCs hold 15
    groups of 8 SMs, so 16 slots raise) or the context cannot be made."""
    from repro_torch.core import sm_partition as smp
    key = (dev.index, part.num_slots, part.slot_sms, part.slots)
    g = _GREEN.get(key)
    if g is None:
        widths = smp.split(dev.index, part.num_slots, part.slot_sms)
        if widths != (part.slot_sms,) * part.num_slots:
            raise PartitionError(
                f"{torch.cuda.get_device_name(dev)}: a split into "
                f"{part.num_slots} x {part.slot_sms} SMs made groups of "
                f"{list(widths)} SMs")
        ctx, stream, sms = smp.create(dev.index, part.num_slots,
                                      part.slot_sms, part.slots)
        if sms != part.sms:
            raise RuntimeError(f"green context over slots {part.slots} "
                               f"holds {sms} SMs, not {part.sms}")
        g = _GREEN[key] = GreenContext(
            ctx, torch.cuda.ExternalStream(stream, device=dev))
    return g


class GMIContext(NamedTuple):
    """Where one GMI's work runs: the card and the GMI's own stream (None
    on the CPU, which has no streams), its SMs (``partition``; None on the
    CPU) and, for a share of the card, the green context that holds it to
    those SMs (``green``; the stream is the green context's)."""
    device: torch.device
    stream: Optional[torch.cuda.Stream]
    partition: Optional[SMPartition] = None
    green: Optional[GreenContext] = None

    def scope(self):
        """A context manager that makes this GMI's green context (if any)
        and then its stream current, and restores both on exit: launches
        through the runtime go to the current context, so both are
        needed."""
        if self.stream is None:
            return contextlib.nullcontext()
        if self.green is None:
            return torch.cuda.stream(self.stream)
        return _green_scope(self.green.ctx, self.stream)


@contextlib.contextmanager
def _green_scope(ctx: int, stream):
    from repro_torch.core import sm_partition as smp
    smp.push(ctx)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        smp.pop(ctx)


@dataclass(frozen=True)
class InstanceGrid:
    """The axis backend's counterpart of the reference's instance ``Mesh``:
    ``devices`` holds the logical device ids in the (g, t[, d]) grid, in
    the mesh's layout; ``gmi_ids`` the (g, t) GMI ids; ``contexts`` each
    GMI's :class:`GMIContext`, row-major over (g, t)."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    gmi_ids: np.ndarray
    contexts: Tuple[GMIContext, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(s) for s in self.devices.shape)

    @property
    def device(self) -> torch.device:
        return self.contexts[0].device


class GMIManager:
    """Global registry of instances and their layout (Listing 1)."""

    def __init__(self, devices: Optional[Sequence] = None,
                 devices_per_gpu: Optional[int] = None,
                 backend: str = "axis", device="cuda"):
        self.device = torch.device(device)
        if devices is None:
            n = torch.cuda.device_count() if self.device.type == "cuda" \
                else 1
            devices = list(range(n))
        self.devices = list(devices)
        self.devices_per_gpu = devices_per_gpu or len(self.devices)
        self.backend = backend
        self.gmis: Dict[int, GMI] = {}
        self.groups: Dict[str, List[int]] = {}
        self._contexts: Dict[int, GMIContext] = {}

    # -- Listing 1 API ---------------------------------------------------
    def add_gmi(self, gmi_id: int, role: str = "holistic",
                resource_fraction: float = 1.0) -> GMI:
        if gmi_id in self.gmis:
            raise ValueError(f"GMI {gmi_id} already registered")
        g = GMI(gmi_id, role, [], -1, self.backend, resource_fraction)
        self.gmis[gmi_id] = g
        return g

    def set_gpu(self, gmi_id: int, gpu_id: int):
        """Attach a GMI to a physical device group and carve its slice."""
        g = self.gmis[gmi_id]
        start = gpu_id * self.devices_per_gpu
        pool = list(range(start, start + self.devices_per_gpu))
        taken = [d for other in self.gmis.values()
                 if other.gpu_id == gpu_id for d in other.device_ids]
        free = [d for d in pool if d not in taken]
        want = max(int(round(self.devices_per_gpu * g.resource_fraction)), 1)
        if len(free) < want:
            raise ValueError(
                f"GPU {gpu_id}: need {want} devices, {len(free)} free "
                f"(resource overcommit — paper Alg.2 'not runnable')")
        g.gpu_id = gpu_id
        g.device_ids = free[:want]

    def get_group(self, gmi_id: int, name: str = "default") -> str:
        self.groups.setdefault(name, [])
        if gmi_id not in self.groups[name]:
            self.groups[name].append(gmi_id)
        self.gmis[gmi_id].group = name
        return name

    # -- layout queries ----------------------------------------------------
    def gmi_to_gpu_mapping(self, role: Optional[str] = None) \
            -> List[List[int]]:
        """The MPL list of Algorithm 1: MPL[g] = GMI ids on GPU g."""
        sel = [g for g in self.gmis.values()
               if role is None or g.role == role]
        gpus = sorted({g.gpu_id for g in sel})
        return [[g.gmi_id for g in sel if g.gpu_id == gid] for gid in gpus]

    def submesh(self, gmi_id: int) -> GMIContext:
        """The instance's own context on the card: its SMs
        (:func:`sm_partition`) and a stream that runs on them (a green
        context's for a share of the card, a stream of its own for the
        whole card), made on first use and kept; no stream on the CPU.
        On the MIG-like backend a GMI's gradients reach others only
        through the host."""
        if gmi_id not in self.gmis:
            raise KeyError(f"GMI {gmi_id} is not registered")
        dev = resolve_device(self.device)
        if dev.type != "cuda":
            return GMIContext(dev, None)
        c = self._contexts.get(gmi_id)
        if c is None:
            props = torch.cuda.get_device_properties(dev)
            g = SM_GRANULARITY.get(props.major)
            if g is None:
                raise RuntimeError(
                    f"{props.name}: no SM partition granularity known for "
                    f"compute capability {props.major}.{props.minor}")
            part = sm_partition(self.gmis[gmi_id], self.devices_per_gpu,
                                props.multi_processor_count, g)
            if part.whole:
                c = GMIContext(dev, torch.cuda.Stream(dev), part)
            else:
                green = green_context(dev, part)
                c = GMIContext(dev, green.stream, part, green)
            self._contexts[gmi_id] = c
        return c

    def instance_mesh(self, role: str, axes=("gpu", "inst")) -> InstanceGrid:
        """Axis backend: one shared grid (gpu × instance) over all GMIs of a
        role — instances are coordinates along ``inst``; LGR reduces over
        these axes.  Multi-device GMIs (resized slices) contribute ALL
        their ids along a trailing ``dev`` axis."""
        mpl = self.gmi_to_gpu_mapping(role)
        if not mpl:
            raise ValueError(f"no GMIs with role {role}")
        t = len(mpl[0])
        if any(len(row) != t for row in mpl):
            raise ValueError("axis backend needs a rectangular GMI layout")
        sizes = {self.gmis[gmi_id].num_devices
                 for row in mpl for gmi_id in row}
        if 0 in sizes:
            raise ValueError(
                f"role {role} has GMIs with no devices attached "
                "(set_gpu not called)")
        if len(sizes) > 1:
            raise ValueError(
                f"axis backend needs uniform devices-per-GMI, got {sizes} "
                "for role " + role)
        d = sizes.pop()
        if d > 1 and "dev" in axes:
            raise ValueError("axes may not already contain 'dev'")
        ids = np.array(mpl, dtype=np.int64)
        grid = np.empty((len(mpl), t, d), dtype=object)
        for gi, row in enumerate(mpl):
            for ii, gmi_id in enumerate(row):
                for di, dev_id in enumerate(self.gmis[gmi_id].device_ids):
                    grid[gi, ii, di] = self.devices[dev_id]
        if d == 1:
            grid, names = grid[:, :, 0], tuple(axes)
        else:
            names = tuple(axes) + ("dev",)
        return InstanceGrid(grid, names, ids,
                            tuple(self.submesh(int(i)) for i in ids.flat))

    def summary(self) -> str:
        lines = [f"GMIManager(backend={self.backend}, "
                 f"devices={len(self.devices)}, "
                 f"per_gpu={self.devices_per_gpu})"]
        for g in sorted(self.gmis.values(), key=lambda x: x.gmi_id):
            lines.append(
                f"  GMI {g.gmi_id}: role={g.role} gpu={g.gpu_id} "
                f"devices={g.device_ids} frac={g.resource_fraction}")
        return "\n".join(lines)


class DRLRole:
    """Process-based GMI programming base class (paper Listing 1)."""

    def __init__(self, manager: GMIManager, gmi_id: int, role: str,
                 gpu_id: int, resource_fraction: float = 1.0):
        self.gmi_id = gmi_id
        self.role = role
        self.mgr = manager
        self.mgr.add_gmi(gmi_id, role, resource_fraction)
        self.mgr.set_gpu(gmi_id, gpu_id)
        self.group = self.mgr.get_group(gmi_id, role)

    # communication primitives are provided by repro_torch.core.channels /
    # repro_torch.comm; subclasses implement the execution routine:
    def gmi_run(self, *args, **kwargs):
        raise NotImplementedError
