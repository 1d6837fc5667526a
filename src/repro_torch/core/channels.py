"""Channel-based experience sharing — MCC (paper §4.2), device-resident;
port of ``repro/core/channels.py`` (experience half).

Four services connect agent instances to trainer instances in async DRL:

* Dispenser (per agent)  — categorizes experience into per-field channels
  (state / action / reward / done / bootstrap) at collection granularity.
* Compressor (system)    — raises transfer granularity by batching channel
  payloads across agents into large contiguous moves.
* Migrator (system)      — routes channel payloads to trainers: direct
  forward when agent and trainer share a device group; least-loaded
  distribution otherwise.
* Batcher (per trainer)  — slices (small-batch, high update frequency) or
  stacks (large-batch, noise reduction) into training batches.

Each agent *group* (agents sharing a GPU per ``gmi_gpu``; all agents when
no placement is given) owns a :class:`ChannelRing`: per-channel buffers on
the payloads' device with room for ``slots x T x N`` samples, push ``s`` in
the slot-aligned column block ``[s*N, (s+1)*N)`` (the layout of
``kernels/channel_pack.py``).  ``push`` writes the agent's whole block in
place with ``ops.pack_channels`` (one kernel launch on the card, the plain
version on the CPU); ``produce`` hands the ring's own storage to a
zero-copy producer (``rl.rollout.collect_ring``).  ``flush`` hands the
valid slots to the consumer as one slice per channel (two and a
concatenation on a wrapped read) and the Migrator routes per group.

Torch tensors are mutable where JAX arrays are not: a snapshot's slices
are views of the ring's storage, so a ring lets go of its storage at
EVERY snapshot and the next push starts on freshly allocated buffers.  No
later push can then overwrite what a consumer holds.

With ``overlap=True`` each ring alternates storage *generations* (paper
§4.1): pushes stage payload references (no device work on the producer
side) and ``flush`` becomes a swap: the back generation is packed in one
``pack_generation`` and parked one round, while what the trainers get is
the previous swap.  Ring-overflow spills are delivered in push order,
ahead of the swap they preceded, and :meth:`MultiChannelPipeline.drain`
empties both generations: no sample is lost or duplicated under any
interleaving of pushes and flushes.  The serve/train overlap itself is
modeled by dispatch order on one stream, as in the reference.

``TransferStats`` counts one transfer per channel per routed group.  On a
single-group layout (no placement map; the Table-8 configuration) that is
one transfer per channel per flush, comparable with the UCC baseline
(:class:`UniChannelPipeline`).  :class:`HostStagedPipeline` keeps the
host-list staging baseline.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.channel_pack import (CHANNELS, alloc_rings,
                                              pack_generation,
                                              version_tensor)
from repro_torch.rl.a3c import Experience
from repro_torch.utils import resolve_device, tree_leaves


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def _nbytes(x) -> int:
    # a Python-int actor version travels as the int32 it becomes in a ring
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 4


@dataclass
class TransferStats:
    num_transfers: int = 0
    total_bytes: int = 0
    ops: int = 0

    def record(self, tree):
        leaves = tree_leaves(tree)
        self.num_transfers += 1
        self.ops += len(leaves)
        self.total_bytes += sum(_nbytes(x) for x in leaves)

    @property
    def bytes_per_transfer(self) -> float:
        # zero transfers -> 0.0, never a ZeroDivisionError
        return self.total_bytes / max(self.num_transfers, 1)


def _payloads(exp: Experience) -> Dict[str, torch.Tensor]:
    return {c: getattr(exp, c) for c in CHANNELS}


# ------------------------------------------------------------- ring buffer -
class ChannelRing:
    """Per-channel ring on the device, one slot per push.

    ``slots`` pushes of fixed (T, N, ...) shape fit before the ring wraps
    and overwrites the oldest slot.  ``snapshot`` returns the valid slots
    oldest-first as one slice per channel and empties the ring; the ring
    then drops its storage (the consumer owns it) and the next push
    allocates afresh.

    ``double_buffered=True`` turns ``snapshot`` into a generation swap:
    pushes stage payload references and the swap packs the back
    generation with ``pack_generation``, whose output the consumer owns.
    """

    _PRODUCED = ("obs", "actions", "rewards", "dones")

    def __init__(self, slots: int, double_buffered: bool = False):
        assert slots >= 1
        self.slots = int(slots)
        self.double_buffered = bool(double_buffered)
        self.bufs: Optional[Dict[str, torch.Tensor]] = None
        self._staged: List[Dict[str, torch.Tensor]] = []  # double-buffer front
        self.head = 0          # next slot to write
        self.count = 0         # valid slots (<= slots)
        self.shape: Optional[Tuple[int, int]] = None   # (T, N)
        self._sig = None       # full per-push payload shapes

    def _check_sig(self, sig, shape):
        if self._sig is None:
            self._sig, self.shape = sig, shape
        elif self._sig != sig:
            raise ValueError(
                f"ring expects payload shapes {self._sig}, got {sig}")

    def _bump(self):
        self.head = (self.head + 1) % self.slots
        self.count = min(self.count + 1, self.slots)

    def append(self, exp: Experience) -> None:
        pay = _payloads(exp)
        self._check_sig(tuple(_shape(pay[c]) for c in CHANNELS),
                        tuple(pay["rewards"].shape))
        if self.double_buffered:
            if self.count == self.slots:   # ring semantics: evict oldest
                self._staged.pop(0)
            self._staged.append(pay)
        else:
            if self.bufs is None:
                assert self.head == 0
                self.bufs = alloc_rings(pay, self.slots)
            ops.pack_channels(self.bufs, pay, self.head)
        self._bump()

    # ------------------------------------------- zero-copy producer slot --
    def acquire(self, T: int, N: int, obs_dim: int, act_dim: int, *,
                device="cuda"):
        """Hand out the ring's live producer channels plus the slot index
        for a zero-copy producer (``rl.rollout.collect_ring``), which
        writes obs/action/reward/done for slot ``head`` into the returned
        buffers in place.  The four buffers are DETACHED from the ring
        until :meth:`commit` reattaches them; the producer writes into
        exactly those tensors and keeps no other reference.  Blocking
        rings only: a double-buffered ring's pushes already stage
        references."""
        if self.double_buffered:
            raise ValueError(
                "acquire/commit targets blocking rings; double-buffered "
                "rings stage payload references (use append)")
        self._check_sig(((T, N, obs_dim), (T, N, act_dim), (T, N), (T, N),
                         (N,), ()), (T, N))
        if self.bufs is None:
            assert self.head == 0
            S, dev = self.slots, resolve_device(device)
            self.bufs = {
                "obs": torch.zeros((T, S * N, obs_dim), device=dev),
                "actions": torch.zeros((T, S * N, act_dim), device=dev),
                "rewards": torch.zeros((T, S * N), device=dev),
                "dones": torch.zeros((T, S * N), device=dev),
                "bootstrap": torch.zeros((S, N), device=dev),
                "actor_version": torch.zeros((S, 1), dtype=torch.int32,
                                             device=dev),
            }
        out = {c: self.bufs.pop(c) for c in self._PRODUCED}
        return out, self.head

    def commit(self, bufs: Dict[str, torch.Tensor], bootstrap,
               actor_version) -> None:
        """Reattach the producer-written channels from :meth:`acquire` and
        finalize the slot: the bootstrap and actor_version rows land as two
        small in-place row writes, then the write pointer bumps — the slot
        becomes visible to ``snapshot`` exactly like an ``append``-ed
        push."""
        assert self.bufs is not None and self.shape is not None
        missing = [c for c in self._PRODUCED if c not in bufs]
        assert not missing, f"commit missing channels {missing}"
        self.bufs.update({c: bufs[c] for c in self._PRODUCED})
        s = self.head
        self.bufs["bootstrap"][s] = bootstrap.reshape(-1)
        self.bufs["actor_version"][s] = version_tensor(
            actor_version, bootstrap.device).reshape(1)
        self._bump()

    def snapshot(self) -> Dict[str, torch.Tensor]:
        """Valid slots oldest-first as channel tensors; empties the ring.

        Double-buffered rings swap generations instead: the back
        generation is packed and handed to the consumer; staging restarts
        immediately."""
        assert self.count > 0
        if self.double_buffered:
            staged, self._staged = self._staged, []
            self.head = 0
            self.count = 0
            return pack_generation(staged)

        assert self.bufs is not None
        S, (_, N) = self.slots, self.shape
        start = (self.head - self.count) % S
        bufs, count = self.bufs, self.count
        # the consumer now owns this storage (its slices are views of it)
        self.bufs = None
        if count == S and start == 0:
            out = dict(bufs)
        else:
            def cols(buf, lo, hi):        # env-column range [lo, hi) slots
                return buf[:, lo * N:hi * N]

            def rows(buf, lo, hi):
                return buf[lo:hi]

            out = {}
            end = start + count
            for c in CHANNELS:
                take = rows if c in ("bootstrap", "actor_version") else cols
                if end <= S:
                    out[c] = take(bufs[c], start, end)
                else:                     # wrapped read: two slices
                    out[c] = torch.cat(
                        [take(bufs[c], start, S), take(bufs[c], 0, end - S)],
                        dim=0 if take is rows else 1)
        self.head = 0
        self.count = 0
        out["bootstrap"] = out["bootstrap"].reshape(-1)
        out["actor_version"] = out["actor_version"].reshape(-1)
        return out


# ---------------------------------------------------------------- services -
class Dispenser:
    """Per-agent host-staged categorization (§4.2 first service), kept for
    the :class:`HostStagedPipeline` baseline.  In the device-resident
    pipeline the typed per-field split happens in ``pack_channels``."""

    def __init__(self, agent_gmi: int):
        self.agent_gmi = agent_gmi
        self.out: Dict[str, List] = {c: [] for c in CHANNELS}

    def push(self, exp: Experience):
        for c in CHANNELS:
            self.out[c].append(getattr(exp, c))

    def drain(self) -> Dict[str, List]:
        out, self.out = self.out, {c: [] for c in CHANNELS}
        return out


class Compressor:
    """System-wide: batch channel payloads into large transfers.

    ``record_flush`` accounts a device-resident flush (one transfer per
    channel per group); ``compress`` is the host-staging path of
    :class:`HostStagedPipeline`."""

    def __init__(self):
        self.stats = TransferStats()

    def record_flush(self, groups: Sequence[Dict[str, torch.Tensor]]) -> None:
        # groups route to different trainers, so they are physically
        # separate moves (a single-group flush is one per channel)
        for g in groups:
            for c in CHANNELS:
                self.stats.record(g[c])

    def compress(self, per_agent: Sequence[Dict[str, List]]) \
            -> Dict[str, torch.Tensor]:
        merged: Dict[str, torch.Tensor] = {}
        dev = per_agent[0]["rewards"][0].device
        for c in CHANNELS:
            items = [x for d in per_agent for x in d[c]]
            if not items:
                continue
            arrs = [version_tensor(x, dev) for x in items] \
                if c == "actor_version" else items
            if arrs[0].dim() == 0:
                merged[c] = torch.stack(arrs)
            else:
                # concat along the env axis (dim 1 for (T,N,...) payloads,
                # dim 0 for (N,) bootstraps)
                merged[c] = torch.cat(arrs, dim=1 if arrs[0].dim() >= 2
                                      else 0)
            self.stats.record(merged[c])      # ONE transfer per channel
        return merged


class Migrator:
    """System-wide: route compressed channels to trainer instances."""

    def __init__(self, trainer_gmis: Sequence[int],
                 gmi_gpu: Optional[Dict[int, int]] = None):
        self.trainer_gmis = list(trainer_gmis)
        self.gmi_gpu = gmi_gpu or {}
        self.load = {t: 0 for t in self.trainer_gmis}

    def route(self, channels: Dict[str, torch.Tensor],
              agent_gpu: Optional[int] = None) -> int:
        """Pick the destination trainer: same-GPU direct forward if any,
        otherwise least-loaded (paper §4.2 migrator policy)."""
        same = [t for t in self.trainer_gmis
                if agent_gpu is not None
                and self.gmi_gpu.get(t) == agent_gpu]
        pool = same or self.trainer_gmis
        dst = min(pool, key=lambda t: self.load[t])
        n = channels["rewards"].shape[1] if "rewards" in channels else 1
        self.load[dst] += int(n)
        return dst


class Batcher:
    """Per-trainer: slice or stack into training batches."""

    def __init__(self, mode: str = "stack", batch_envs: Optional[int] = None):
        assert mode in ("stack", "slice")
        self.mode = mode
        self.batch_envs = batch_envs

    def prepare(self, channels: Dict[str, torch.Tensor]) -> List[Experience]:
        # a batch always carries ONE 0-d version — the OLDEST merged
        # payload's, so staleness is an upper bound for every sample in it
        version = torch.min(torch.atleast_1d(version_tensor(
            channels["actor_version"], channels["rewards"].device)))
        exp = Experience(
            obs=channels["obs"], actions=channels["actions"],
            rewards=channels["rewards"], dones=channels["dones"],
            bootstrap=channels["bootstrap"], actor_version=version)
        if self.mode == "stack" or self.batch_envs is None:
            return [exp]
        N = exp.rewards.shape[1]
        b = self.batch_envs
        out = []
        for s in range(0, N, b):          # ragged tail kept, never dropped
            sl = slice(s, min(s + b, N))
            out.append(Experience(
                obs=exp.obs[:, sl], actions=exp.actions[:, sl],
                rewards=exp.rewards[:, sl], dones=exp.dones[:, sl],
                bootstrap=exp.bootstrap[sl],
                actor_version=exp.actor_version))
        return out


# ---------------------------------------------------------------- pipelines -
class MultiChannelPipeline:
    """Device-resident MCC: ring-pack -> flush -> route -> batch (the
    paper's Dispenser/Compressor/Migrator/Batcher flow)."""

    def __init__(self, agent_gmis: Sequence[int], trainer_gmis: Sequence[int],
                 gmi_gpu: Optional[Dict[int, int]] = None,
                 batch_mode: str = "stack",
                 batch_envs: Optional[int] = None,
                 ring_slots: Optional[int] = None,
                 overlap: bool = False):
        self.agent_gmis = list(agent_gmis)
        self.gmi_gpu = gmi_gpu or {}
        self.compressor = Compressor()
        self.migrator = Migrator(trainer_gmis, gmi_gpu)
        self.batchers = {t: Batcher(batch_mode, batch_envs)
                         for t in trainer_gmis}
        self.ring_slots = ring_slots
        self.overlap = bool(overlap)
        # agents sharing a GPU share a ring (direct-forward group); agents
        # with unknown placement share the catch-all group
        self._group_of = {a: self.gmi_gpu.get(a, -1) for a in self.agent_gmis}
        self._group_size: Dict[int, int] = {}
        for g in self._group_of.values():
            self._group_size[g] = self._group_size.get(g, 0) + 1
        self._rings: Dict[Tuple[int, Tuple], ChannelRing] = {}
        # ring-overflow spill: a full ring is snapshotted before the
        # overwriting push lands, so agents pushing more often than the
        # consumer flushes lose nothing
        self._pending: Dict[int, List[Dict[str, torch.Tensor]]] = {}
        # overlap mode: the previous flush's swapped-out buffers, parked
        # one round so trainers consume round r-1 while agents serve r
        self._inflight: List[Tuple[int, Dict[str, torch.Tensor]]] = []
        self.spill_count = 0
        self.occupancy_high_water = 0.0
        self.delivered_samples = 0
        # per-flush (host seconds, bytes) channel-transfer samples; bounded
        self._transfer_samples: List[Tuple[float, int]] = []

    def _ring_for_sig(self, group: int, sig) -> ChannelRing:
        key = (group, sig)
        ring = self._rings.get(key)
        if ring is None:
            slots = self.ring_slots or self._group_size[group]
            ring = ChannelRing(slots, double_buffered=self.overlap)
            self._rings[key] = ring
        return ring

    def _spill_if_full(self, group: int, ring: ChannelRing) -> None:
        if ring.count == ring.slots:       # would evict an unread slot
            self._pending.setdefault(group, []).append(ring.snapshot())
            self.spill_count += 1

    def push(self, agent_gmi: int, exp: Experience):
        group = self._group_of[agent_gmi]
        sig = tuple(tuple(getattr(exp, c).shape)
                    for c in ("obs", "actions", "rewards"))
        ring = self._ring_for_sig(group, sig)
        self._spill_if_full(group, ring)
        ring.append(exp)
        self.occupancy_high_water = max(self.occupancy_high_water,
                                        ring.count / ring.slots)

    def produce(self, agent_gmi: int, T: int, N: int, obs_dim: int,
                act_dim: int, producer, *, device="cuda") -> None:
        """Zero-copy push: hand the group ring's live slot storage (on
        ``device``) to the producer instead of packing a staged payload.

        ``producer(bufs, slot) -> (bufs, bootstrap, actor_version)``
        receives the ring's own ``{obs, actions, rewards, dones}`` buffers
        plus the slot index, writes the slot in place and returns the
        buffers with the slot's bootstrap values and actor version — the
        ``rl.rollout.collect_ring`` contract.  Spill-not-drop and occupancy
        accounting match :meth:`push`.  Blocking rings only."""
        if self.overlap:
            raise ValueError(
                "produce targets blocking rings; overlap mode stages "
                "payload references (push is already zero-cost on the "
                "producer side)")
        group = self._group_of[agent_gmi]
        ring = self._ring_for_sig(
            group, ((T, N, obs_dim), (T, N, act_dim), (T, N)))
        self._spill_if_full(group, ring)
        bufs, slot = ring.acquire(T, N, obs_dim, act_dim, device=device)
        bufs, bootstrap, version = producer(bufs, slot)
        ring.commit(bufs, bootstrap, version)
        self.occupancy_high_water = max(self.occupancy_high_water,
                                        ring.count / ring.slots)

    def flush(self) -> Dict[int, List[Experience]]:
        """Move experience toward trainer batches.

        Blocking mode (default): everything pushed since the last flush
        is snapshotted, routed and returned.

        Overlap mode: a buffer swap, not a barrier.  This round's pushes
        (spills first, in push order, then the ring swap) are parked in
        flight, and what is returned is the PREVIOUS flush's swap.  The
        first flush returns ``{}``; :meth:`drain` delivers the tail."""
        t0 = time.perf_counter()
        current: List[Tuple[int, Dict[str, torch.Tensor]]] = []
        for gkey, snaps in self._pending.items():
            current.extend((gkey, ch) for ch in snaps)
        self._pending = {}
        for (gkey, _), ring in self._rings.items():
            if ring.count:
                current.append((gkey, ring.snapshot()))
        if self.overlap:
            groups, self._inflight = self._inflight, current
        else:
            groups = current
        if not groups:
            return {}
        bytes_before = self.compressor.stats.total_bytes
        self.compressor.record_flush([ch for _, ch in groups])
        out: Dict[int, List[Experience]] = {}
        for gkey, ch in groups:
            dst = self.migrator.route(
                ch, agent_gpu=None if gkey == -1 else gkey)
            out.setdefault(dst, []).extend(self.batchers[dst].prepare(ch))
            self.delivered_samples += ch["rewards"].numel()
        nbytes = self.compressor.stats.total_bytes - bytes_before
        # one (seconds, bytes) sample per delivering flush, host time of
        # the snapshot, routing and batching dispatch
        self._transfer_samples.append((time.perf_counter() - t0, nbytes))
        del self._transfer_samples[:-64]
        return out

    def take_transfer_samples(self) -> List[Tuple[float, int]]:
        """Per-flush (seconds, bytes) channel-transfer samples since the
        last call."""
        samples, self._transfer_samples = self._transfer_samples, []
        return samples

    def drain(self) -> Dict[int, List[Experience]]:
        """Pipeline-ending flush: deliver the in-flight back buffers AND
        any still-buffered front pushes (two swap steps in overlap mode,
        one plain flush otherwise)."""
        out: Dict[int, List[Experience]] = {}
        for _ in range(2 if self.overlap else 1):
            for dst, bs in self.flush().items():
                out.setdefault(dst, []).extend(bs)
        return out

    def clone_for(self, agent_gmis: Sequence[int],
                  trainer_gmis: Sequence[int],
                  gmi_gpu: Optional[Dict[int, int]] = None) \
            -> "MultiChannelPipeline":
        """A fresh pipeline over a new layout carrying THIS pipeline's
        configuration (batching, ring sizing, overlap); counters restart."""
        some_batcher = next(iter(self.batchers.values()), None)
        return MultiChannelPipeline(
            agent_gmis, trainer_gmis, gmi_gpu=gmi_gpu,
            batch_mode=some_batcher.mode if some_batcher else "stack",
            batch_envs=some_batcher.batch_envs if some_batcher else None,
            ring_slots=self.ring_slots, overlap=self.overlap)

    def ring_occupancy(self) -> float:
        """Current front-buffer fill fraction (peak across live rings)."""
        occ = [r.count / r.slots for r in self._rings.values()]
        return max(occ) if occ else 0.0

    def take_occupancy_high_water(self) -> float:
        """Peak fill fraction any ring reached since the last call; resets
        the mark."""
        hw, self.occupancy_high_water = self.occupancy_high_water, 0.0
        return hw

    @property
    def stats(self) -> TransferStats:
        return self.compressor.stats


class HostStagedPipeline:
    """The seed MCC: host-list staging + per-flush concatenation, single
    destination per flush.  Kept as the before/after baseline."""

    def __init__(self, agent_gmis: Sequence[int], trainer_gmis: Sequence[int],
                 gmi_gpu: Optional[Dict[int, int]] = None,
                 batch_mode: str = "stack",
                 batch_envs: Optional[int] = None):
        self.dispensers = {a: Dispenser(a) for a in agent_gmis}
        self.compressor = Compressor()
        self.migrator = Migrator(trainer_gmis, gmi_gpu)
        self.batchers = {t: Batcher(batch_mode, batch_envs)
                         for t in trainer_gmis}

    def push(self, agent_gmi: int, exp: Experience):
        self.dispensers[agent_gmi].push(exp)

    def flush(self) -> Dict[int, List[Experience]]:
        per_agent = [d.drain() for d in self.dispensers.values()]
        per_agent = [d for d in per_agent if any(d[c] for c in CHANNELS)]
        if not per_agent:
            return {}
        channels = self.compressor.compress(per_agent)
        dst = self.migrator.route(channels)
        return {dst: self.batchers[dst].prepare(channels)}

    def drain(self) -> Dict[int, List[Experience]]:
        """API parity with :class:`MultiChannelPipeline` (host staging has
        no in-flight buffers — drain is a plain flush)."""
        return self.flush()

    @property
    def stats(self) -> TransferStats:
        return self.compressor.stats


class UniChannelPipeline:
    """UCC baseline: every experience tuple is its own fine-grained
    transfer (one op per field per agent per round — Table 8's loser)."""

    def __init__(self, trainer_gmis: Sequence[int]):
        self.trainer_gmis = list(trainer_gmis)
        self.stats = TransferStats()
        self._rr = 0

    def send(self, exp: Experience) -> int:
        for c in CHANNELS:
            self.stats.record(getattr(exp, c))  # one transfer PER FIELD
        dst = self.trainer_gmis[self._rr % len(self.trainer_gmis)]
        self._rr += 1
        return dst
