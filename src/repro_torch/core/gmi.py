"""GMI — GPU Multiplexing Instance (paper §3), port of
``repro/core/gmi.py``.

A GMI is a named, resource-budgeted instance assigned to one DRL role.
Device ids stay logical, as in the reference's launcher: a GMI owns
``round(devices_per_gpu * resource_fraction)`` ids of its GPU's pool, and
the manager checks overcommit, rectangular layouts and uniform device
counts on those ids.  The manager also holds one ``torch.device``, the
card every GMI of this process runs on.  The two backends of the
reference map like this:

* ``axis``    (MPS-like): :meth:`GMIManager.instance_mesh` returns an
  :class:`InstanceGrid`, the (gpu, inst[, dev]) grid of a role with one
  CUDA stream per GMI on the card.  The LGR schedules of
  ``repro_torch.comm`` reduce grid-stacked tensors over it.
* ``submesh`` (MIG-like): :meth:`GMIManager.submesh` returns one GMI's own
  :class:`GMIContext` (device, stream); such GMIs reduce only through the
  host (``comm.mpr_host``).

``resource_fraction`` is bookkeeping: the streams share the whole card,
as MPS does without a thread-percentage cap.

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


class GMIContext(NamedTuple):
    """Where one GMI's work runs: the card and the GMI's own stream (None
    on the CPU, which has no streams)."""
    device: torch.device
    stream: Optional[torch.cuda.Stream]

    def scope(self):
        """A context manager that makes this GMI's stream current."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


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
        self._streams: Dict[int, torch.cuda.Stream] = {}

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
        """The instance's own (device, stream): one CUDA stream per GMI,
        made on first use and kept; no stream on the CPU.  On the MIG-like
        backend a GMI's gradients reach others only through the host."""
        if gmi_id not in self.gmis:
            raise KeyError(f"GMI {gmi_id} is not registered")
        dev = resolve_device(self.device)
        if dev.type != "cuda":
            return GMIContext(dev, None)
        s = self._streams.get(gmi_id)
        if s is None:
            s = self._streams[gmi_id] = torch.cuda.Stream(dev)
        return GMIContext(dev, s)

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
