"""Slot-based continuous-batching request engine (port of
``repro/serve/engine.py``; paper §3: one serving GMI's execution loop).

The engine owns a fixed-slot decode batch.  Two cache regimes, as in the
reference:

* **Paged (default).**  Attention caches live in a batch-free pool of
  fixed-size pages (``attention.PagedKVCache``, one pool per layer,
  stacked); each decode slot owns a row of an engine-held page table
  mapping virtual page v (absolute positions ``[v*page_size,
  (v+1)*page_size)``) to a physical page.  Page 0 is the trash page: idle
  rows and unmapped writes land there and stay masked.  Pages are reserved
  for a request's lifetime (prompt + budget) at admission.
* **Dense (``paged=False``).**  Each slot owns a ``max_seq``-deep cache row.

The cache is a tree (``transformer.cache_nodes``): a dense stack's one
stacked cache, or a patterned stack's dict of nodes.  Recurrent states
(xlstm's mLSTM/sLSTM, zamba2's Mamba2) are fixed-size per slot and stay
batched beside the pool: a prefill splices them into the slot's batch row,
a chunked prefill first zeroes that row (``_reset_row``) and continues
from it, and decode pins the rows of idle slots.  zamba2's shared
attention applications each get a paged pool; xlstm's tree holds no paged
node at all, so its page pool is bookkeeping only, as in the reference.
Prefix sharing is off for patterned stacks and for mixture-of-experts
stacks, as there; an MoE engine chunks its prefill only with
``cfg.moe_route_block`` set, and rounds the chunk up to a multiple of it
(the reference's rule: routing is then the same whole or chunked).

On top of pages: batched prefill (same-length prompts admitted in one step
share one prefill dispatch), chunked prefill (``chunk_prefill=C``: long
prompts prefill C tokens per engine step, interleaved with decode) and
shared-prefix reuse with one eager copy-on-write at a divergence inside a
block.  The host bookkeeping (page pool, page table, sha1 chain-hash prefix
index, copy-on-write planning) is the reference's, line for line, so the
port's page tables equal the reference's for the same request sequence.

What changes in the port:

* JAX's donated, functional cache updates become in-place writes on one
  CUDA stream: decode, splice, clear, copy-on-write and chunk prefill all
  mutate ``self._caches``.
* Every whole-prompt prefill runs the flash kernel in each attention
  layer, and every paged decode step runs the paged gather-decode kernel
  in each layer (the reference's ``decode_kernel=True``, here the only
  route).  A prefill chunk gathers its pages in plain PyTorch, as in the
  reference.  Every prefill, whole or chunked, runs the mLSTM kernel once
  in each mLSTM block; an mLSTM decode step is plain ops, as in the
  reference.
* The one host sync per decode step is the token readback, as in the
  reference; a prefill syncs once for its first tokens.
* Sampled tokens (``temperature > 0``) cannot reproduce JAX's threefry
  draws: they come from a Gumbel-max over a counter hash of (request
  seed, position, vocab index) (``_pick_tokens``), so a draw still depends
  only on the request's seed and position, never on batch composition.
* ``mesh`` becomes an explicit ``device`` and an optional ``gmi`` (a
  ``core/gmi.py::GMIContext``): the engine's device work runs under the
  GMI's own CUDA stream, and its one token readback a step synchronises
  that stream only.  Without ``gmi`` it runs on the current stream.
* A migrated cache (``submit_prefilled``, the decode half of
  ``serve/disagg.py``) is spliced on the engine's stream after that
  stream has waited for the payload's pack (``core/channels.py::
  CacheChannel``), and its buffers are marked as used there.
* A vision request's patches (``Request.extras["patches"]``) go to its
  whole-prompt prefill, ahead of its text tokens; such requests are
  admitted one at a time and share no prefix, as in the reference.
"""
from __future__ import annotations

import contextlib
import hashlib
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.envs.physics import hash_u32
from repro_torch.models import transformer as T
from repro_torch.models.attention import PagedKVCache
from repro_torch.serve.telemetry import ServingTelemetry
from repro_torch.utils import resolve_device, tree_leaves, tree_map

_REQUEST_IDS = itertools.count()


@dataclass
class Request:
    """One generation request.  ``tokens`` is the prompt (1-D int array);
    ``max_new_tokens`` counts every generated token, including the one the
    prefill emits.  ``extras`` carries additional prompt modalities (e.g.
    ``{"patches": (num_patches, feat)}`` for vision frontends, which the
    port does not run yet); each entry gets a leading batch dim at
    admission.  ``deadline_s`` is a TTL from submit time: a request still
    queued past it completes with status ``"timeout"``."""
    tokens: Any
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0
    eos_id: Optional[int] = None
    extras: Optional[Dict[str, Any]] = None
    deadline_s: Optional[float] = None
    rid: int = field(default_factory=lambda: next(_REQUEST_IDS))

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


@dataclass
class Completion:
    """A retired request: ``tokens`` are the generated ids (prefill token
    first), ``latency_s`` is submit-to-retire wall time.  ``status`` is
    ``"ok"`` for a normal retire, ``"timeout"`` for a deadline-expired
    queued request (empty ``tokens``), ``"failed"`` for a request whose
    engine died mid-decode with retries exhausted."""
    request: Request
    tokens: List[int]
    prompt_tokens: int
    latency_s: float
    status: str = "ok"

    @property
    def rid(self) -> int:
        return self.request.rid


@dataclass
class _Slot:
    req: Request
    pos: int                     # absolute position of the token being fed
    remaining: int               # decode steps left (budget - prefill token)
    generated: List[int]
    submit_t: float
    pages: List[int] = field(default_factory=list)   # page refs to release
    # chunked-prefill state machine (prefilling while the batch decodes)
    prefilling: bool = False
    chunk_next: int = 0          # next prompt position to prefill
    prompt_total: int = 0
    hashes: Optional[list] = None
    prefill_s: float = 0.0
    t_admit: float = 0.0


class _PagePool:
    """Host-side bookkeeping for the physical page pool: a free stack and
    per-page refcounts.  Page 0 (trash) is pinned forever."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        if self.num_pages < 2:
            raise ValueError("page pool needs >= 2 pages (trash + 1)")
        self.free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self.ref = np.zeros((self.num_pages,), np.int64)
        self.ref[0] = 1

    @property
    def free_count(self) -> int:
        return len(self.free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self.free):
            return None
        out = [self.free.pop() for _ in range(n)]
        for p in out:
            self.ref[p] = 1
        return out

    def retain(self, pid: int):
        self.ref[pid] += 1

    def release(self, pid: int) -> bool:
        self.ref[pid] -= 1
        assert self.ref[pid] >= 0, f"double free of page {pid}"
        if self.ref[pid] == 0:
            self.free.append(pid)
            return True
        return False


class _PrefixIndex:
    """Chain-hash index of promoted prompt-prefix pages.

    ``full[h]`` maps the sha1 chain hash of blocks ``0..j`` (all full) to
    the physical page holding block j.  ``nxt[h]`` maps the chain hash of
    blocks ``0..j-1`` to some page holding a block-j candidate (possibly
    partial) whose tokens are in ``toks[pid]``: the copy-on-write source
    for a divergence inside block j.  Every entry holds one pool ref."""

    def __init__(self, page_size: int):
        self.P = int(page_size)
        self.full: Dict[bytes, int] = {}
        self.nxt: Dict[bytes, int] = {}
        self.toks: Dict[int, Tuple[int, ...]] = {}
        self.keys_of: Dict[int, List[Tuple[str, bytes]]] = {}

    def hashes(self, tokens) -> List[Tuple[bytes, bytes, Tuple[int, ...]]]:
        """Per block j (incl. a trailing partial block):
        ``(chain_prev, chain_self, block_tokens)``."""
        P = self.P
        toks = np.asarray(tokens, np.int32)
        out = []
        prev = b""
        for j in range(-(-len(toks) // P)):
            blk = tuple(int(t) for t in toks[j * P:(j + 1) * P])
            h = hashlib.sha1(prev + np.asarray(blk, np.int32).tobytes())
            out.append((prev, h.digest(), blk))
            prev = h.digest()
        return out

    def entry_count(self, pid: int) -> int:
        return len(self.keys_of.get(pid, ()))

    def pages(self) -> List[int]:
        return list(self.keys_of)

    def add(self, kind: str, key: bytes, pid: int) -> bool:
        d = self.full if kind == "full" else self.nxt
        if key in d:
            return False
        d[key] = pid
        self.keys_of.setdefault(pid, []).append((kind, key))
        return True

    def drop(self, pid: int) -> int:
        """Remove every entry pointing at ``pid``; returns how many."""
        keys = self.keys_of.pop(pid, [])
        for kind, key in keys:
            (self.full if kind == "full" else self.nxt).pop(key, None)
        self.toks.pop(pid, None)
        return len(keys)


class ServeEngine:
    """Continuous-batching engine over one model replica.

    Parameters are the reference's, with ``device`` (default ``"cuda"``)
    and ``gmi`` in place of ``mesh``: ``cfg, params`` (params in the
    reference's tree layout, any device; the engine moves them to
    ``device`` and casts the matmul weights and embedding table to
    ``cfg.dtype`` once, so engines given params already there and in that
    type share them),
    ``max_slots``, ``max_seq``, ``window_override``, ``paged``,
    ``page_size``, ``num_pages`` (default ``max_slots *
    ceil(max_seq/page_size) + 1``), ``batch_prefill``, ``chunk_prefill``,
    ``share_prefix`` (off for patterned and MoE stacks, as in the
    reference).
    ``gmi`` is an optional ``GMIContext``: its device overrides
    ``device``, and the engine's work runs under its stream.
    ``prefill_dispatches`` counts whole-prompt prefill dispatches (each
    runs the flash kernel once an attention layer, or the mLSTM kernel
    once an mLSTM block).
    """

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_seq: int = 128, window_override: Optional[int] = None,
                 device="cuda",
                 telemetry: Optional[ServingTelemetry] = None,
                 name: str = "engine", paged: bool = True,
                 page_size: int = 8, num_pages: Optional[int] = None,
                 batch_prefill: bool = True, chunk_prefill: int = 0,
                 share_prefix: bool = True, gmi=None):
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.name}: encoder-only model has no decode "
                             "step — nothing to serve")
        self.cfg = cfg
        self.gmi = gmi
        self.device = resolve_device(gmi.device if gmi is not None
                                     else device)
        if self.stream is not None:
            # the params (and whatever else the caller made) come from the
            # stream that is current now
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.window_override = window_override
        self.name = name
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.batch_prefill = bool(batch_prefill) and self.paged
        self.chunk_prefill = int(chunk_prefill) if self.paged else 0
        if self.chunk_prefill > 0 and cfg.num_experts:
            # finite-capacity MoE routing is chunk-invariant only when
            # chunk starts land on multiples of the routing block
            if cfg.moe_route_block <= 0:
                raise ValueError(
                    "chunk_prefill with an MoE config requires "
                    "cfg.moe_route_block > 0 (block-local routing) — "
                    "otherwise chunked and whole prefill route differently")
            r = cfg.moe_route_block
            self.chunk_prefill = -(-self.chunk_prefill // r) * r
        self.telemetry = telemetry or ServingTelemetry(self.max_slots)
        # fault-injection seam: called with this engine at the top of
        # step(); raising there kills the engine mid-decode
        self.fault_hook = None
        self.dead = False
        self.timeouts = 0
        self.prefix_fallbacks = 0    # migrated payloads re-queued because a
                                     # promised shared head was evicted
        self.prefill_dispatches = 0
        with self.scope():
            self.params = T.cast_params(
                tree_map(lambda t: t.to(self.device), params), cfg)

        self._queue: Deque[Request] = deque()
        # prefilled-elsewhere payloads awaiting a slot (cache splice only,
        # no local prefill compute), admitted ahead of the raw queue
        # because their prefill cost is already sunk on another GMI
        self._prefilled: Deque[Any] = deque()
        self._slots: List[Optional[_Slot]] = [None] * self.max_slots
        dt = T.torch_dtype(cfg)
        self.pages_per_slot = -(-self.max_seq // self.page_size)
        if self.paged:
            self.num_pages = int(num_pages) if num_pages is not None \
                else self.max_slots * self.pages_per_slot + 1
            with self.scope():
                self._caches = T.init_paged_cache(
                    cfg, self.max_slots, self.max_seq, window_override, dt,
                    page_size=self.page_size, num_pages=self.num_pages,
                    device=self.device)
            self._pool = _PagePool(self.num_pages)
            self._table = np.full((self.max_slots, self.pages_per_slot), -1,
                                  np.int32)
            self._table_dev = None           # rebuilt lazily when dirty
            self._share = bool(share_prefix) and not cfg.block_pattern \
                and cfg.num_experts == 0 \
                and cfg.frontend not in ("vision", "audio")
            self._index = _PrefixIndex(self.page_size)
        else:
            self.num_pages = 0
            with self.scope():
                self._caches = T.init_cache(cfg, self.max_slots,
                                            self.max_seq, window_override,
                                            dt, device=self.device)
            self._pool = None
            self._share = False
        self._cache_bytes = sum(t.numel() * t.element_size()
                                for node in T.cache_nodes(self._caches)
                                for t in node)
        # host mirrors of the decode-batch inputs; idle rows feed
        # (token=0, pos=-1, temp=0) — the negative position routes their
        # paged write to the trash page — and are ignored on the way out
        self._idle_pos = -1 if self.paged else 0
        self._tok = np.zeros((self.max_slots,), np.int32)
        self._pos = np.full((self.max_slots,), self._idle_pos, np.int32)
        self._seed = np.zeros((self.max_slots,), np.int32)
        self._temp = np.zeros((self.max_slots,), np.float32)

    # ---------------------------------------------------- device bodies --
    @property
    def stream(self):
        """The GMI's CUDA stream, or None (current stream, or the CPU)."""
        return self.gmi.stream if self.gmi is not None else None

    def scope(self):
        """A context manager that makes the GMI's stream current."""
        s = self.stream
        return contextlib.nullcontext() if s is None else torch.cuda.stream(s)

    def _prefill(self, tokens: np.ndarray, extras=None):
        batch = {"tokens": torch.as_tensor(tokens, device=self.device)}
        for k, v in (extras or {}).items():
            batch[k] = torch.as_tensor(np.asarray(v)[None],
                                       device=self.device)
        return T.prefill(self.params, self.cfg, batch, self.max_seq,
                         self.window_override)

    def _decode(self, caches, tok, pos, seed, temp, table):
        """tok: (B,) int32 on the device; pos/seed/temp: host arrays."""
        pos_dev = torch.as_tensor(pos, device=self.device)
        logits, _ = T.decode_step(self.params, self.cfg, tok, pos_dev, caches,
                                  self.window_override, page_table=table)
        return _pick_tokens(logits, pos, seed, temp)

    def _insert_paged(self, full, one, row: int, slot: int, table_row):
        """Splice row ``row`` of a dense prefill cache tree into the paged
        tree, in place.  Paged nodes: a scatter through ``table_row`` (M,)
        by each entry's absolute ``slot_pos``, so whole and ring-truncated
        prefills land at their true positions (invalid or unmapped entries
        fall into the trash page).  Non-paged (recurrent-state) leaves
        splice into batch row ``slot`` as in the dense engine."""
        P = self.page_size
        for f, o in zip(T.cache_nodes(full), T.cache_nodes(one)):
            if not isinstance(f, PagedKVCache):
                self._insert_dense(f, o, row, slot)
                continue
            k, v, sp = o.k[:, row], o.v[:, row], o.slot_pos[:, row]
            ok = sp >= 0
            safe = torch.where(ok, sp, 0)
            vp = torch.clamp(safe // P, 0, table_row.shape[0] - 1).long()
            phys = table_row[vp]
            ok = ok & (phys >= 0)
            phys = torch.where(ok, phys, 0).long()
            off = (safe % P).long()
            lidx = torch.arange(sp.shape[0], device=sp.device)[:, None]
            f.k_pages.index_put_((lidx, phys, off), k.to(f.k_pages.dtype))
            f.v_pages.index_put_((lidx, phys, off), v.to(f.v_pages.dtype))
            f.slot_pos.index_put_((lidx, phys, off), torch.where(ok, sp, -1))

    @staticmethod
    def _insert_dense(full, one, row: int, slot: int):
        """Every stacked leaf is (layers or super-blocks, batch, ...):
        splice row ``row`` of the prefill cache tree into batch row
        ``slot``."""
        for f, o in zip(T.cache_nodes(full), T.cache_nodes(one)):
            for fl, ol in zip(f, o):
                fl[:, slot] = ol[:, row]

    def _paged_nodes(self) -> List[PagedKVCache]:
        return [n for n in T.cache_nodes(self._caches)
                if isinstance(n, PagedKVCache)]

    def _reset_row(self, slot: int):
        """Zero batch row ``slot`` of every non-paged (recurrent-state)
        leaf.  Whole-prompt admissions overwrite the row by splice, but a
        chunked prefill continues from the slot's current state, which on
        a reused slot is the previous occupant's final state.  Every
        recurrent init state is all zeros, so this restores a fresh one."""
        for node in T.cache_nodes(self._caches):
            if not isinstance(node, PagedKVCache):
                for t in node:
                    t[:, slot] = 0

    def _clear(self, pids: List[int]):
        """Invalidate the given physical pages (``slot_pos = -1``) in every
        paged node."""
        if pids:
            idx = torch.as_tensor(pids, device=self.device)
            for c in self._paged_nodes():
                c.slot_pos[:, idx] = -1

    def _copy_page(self, src: int, dst: int, keep_below: int):
        """Copy-on-write: duplicate physical page ``src`` into ``dst`` in
        every paged node, keeping only entries at absolute position
        ``< keep_below`` valid."""
        for c in self._paged_nodes():
            sp = c.slot_pos[:, src]
            c.k_pages[:, dst] = c.k_pages[:, src]
            c.v_pages[:, dst] = c.v_pages[:, src]
            c.slot_pos[:, dst] = torch.where((sp >= 0) & (sp < keep_below),
                                             sp, -1)

    # ------------------------------------------------------------- queries --
    @property
    def active_count(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def free_slots(self) -> int:
        return self.max_slots - self.active_count

    @property
    def queue_len(self) -> int:
        return len(self._queue) + len(self._prefilled)

    @property
    def load(self) -> int:
        """Outstanding work — the router's queue-depth routing key."""
        return self.active_count + self.queue_len

    @property
    def busy(self) -> bool:
        return self.load > 0

    @property
    def cache_bytes(self) -> int:
        return self._cache_bytes

    @property
    def free_pages(self) -> int:
        return self._pool.free_count if self.paged else 0

    @property
    def total_pages(self) -> int:
        """Usable (non-trash) physical pages."""
        return self.num_pages - 1 if self.paged else 0

    def _pages_needed(self, prompt_total: int, max_new: int) -> int:
        # cache writes span positions [0, prompt_total + max_new - 1): the
        # final generated token is emitted but never written back
        return -(-(prompt_total + max_new - 1) // self.page_size)

    # ----------------------------------------------------------- lifecycle --
    def submit(self, req: Request) -> int:
        """Queue a request; returns its id.  Admission happens at the next
        :meth:`step` when a slot (and, paged, enough pages) frees up."""
        total = len(req.tokens) + self._extra_tokens(req) + req.max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt+budget {total} exceeds engine "
                f"max_seq {self.max_seq}")
        if self.paged:
            need = self._pages_needed(
                len(req.tokens) + self._extra_tokens(req), req.max_new_tokens)
            if need > self.total_pages:
                raise ValueError(
                    f"request {req.rid}: needs {need} pages, engine pool has "
                    f"{self.total_pages} — can never be admitted")
        self.telemetry.on_submit(req.rid)
        self._queue.append(req)
        return req.rid

    def submit_prefilled(self, payload) -> int:
        """Queue a prefilled-elsewhere cache payload (duck-typed: ``req``,
        ``cache``, ``first_id``, ``prompt_tokens``, ``submit_t``, optional
        ``head_pages``) for splice-only admission: the decode half of
        prefill/decode disaggregation.  The cache must come from the same
        model (cfg/params/max_seq/window) for the splice to be
        well-formed.  ``head_pages`` > 0 promises that the first
        ``head_pages`` full prompt blocks are in this engine's
        shared-prefix index (the sender stripped them from the payload);
        if the promise no longer holds at admission the request re-queues
        for a full local prefill instead: lossless, just slower."""
        req = payload.req
        total = payload.prompt_tokens + req.max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt+budget {total} exceeds engine "
                f"max_seq {self.max_seq}")
        self.telemetry.on_submit(req.rid,
                                 t=getattr(payload, "submit_t", None))
        self._prefilled.append(payload)
        return req.rid

    def take_prefilled(self) -> List[Any]:
        """Remove and return the not-yet-spliced prefilled payloads (they
        are engine-independent: a survivor can splice them as-is)."""
        out = list(self._prefilled)
        self._prefilled.clear()
        return out

    def _extra_tokens(self, req: Request) -> int:
        if self.cfg.frontend == "vision" and req.extras \
                and "patches" in req.extras:
            return int(req.extras["patches"].shape[0])
        return 0

    # --------------------------------------------------------- page plumbing --
    def shared_head_pages(self, tokens) -> int:
        """How many leading FULL prompt blocks of ``tokens`` are currently
        in this engine's shared-prefix index."""
        if not self._share:
            return 0
        n = 0
        for _, h_self, blk in self._index.hashes(tokens):
            if len(blk) < self.page_size or h_self not in self._index.full:
                break
            n += 1
        return n

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate from the free list, evicting index-only shared pages
        (no live slot references them) under pressure."""
        if n <= self._pool.free_count:
            return self._pool.alloc(n)
        for pid in self._index.pages() if self._share else []:
            if self._pool.ref[pid] == self._index.entry_count(pid):
                for _ in range(self._index.drop(pid)):
                    self._pool.release(pid)
                if self._pool.free_count >= n:
                    break
        return self._pool.alloc(n)

    def _table_row_dev(self, slot: int):
        return torch.as_tensor(self._table[slot], device=self.device)

    def _table_device(self):
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self._table, device=self.device)
        return self._table_dev

    def _set_table_row(self, slot: int, row: List[int]):
        self._table[slot, :] = -1
        self._table[slot, :len(row)] = row
        self._table_dev = None

    def _release_slot_pages(self, st: _Slot):
        for pid in st.pages:
            self._pool.release(pid)
        st.pages = []

    def _plan_pages(self, req: Request):
        """Reserve the request's lifetime pages, resolving shared-prefix
        reuse and performing the (at most one) copy-on-write.  Returns
        ``(row, p0, hashes)`` — the slot's page-table row, the first
        prompt position that still needs local prefill, and the chain
        hashes for post-prefill promotion — or None if the pool cannot
        cover it right now."""
        P = self.page_size
        Lp = len(req.tokens) + self._extra_tokens(req)
        need = self._pages_needed(Lp, req.max_new_tokens)
        shared_pids: List[int] = []
        cand = None
        lcp = 0
        hashes = None
        if self._share and not req.extras:
            hashes = self._index.hashes(req.tokens)
            for h_prev, h_self, blk in hashes:
                pid = self._index.full.get(h_self)
                if pid is None or len(blk) < P:
                    break
                shared_pids.append(pid)
            s = len(shared_pids)
            if s < len(hashes):
                h_prev, _, blk = hashes[s]
                c = self._index.nxt.get(h_prev)
                if c is not None:
                    ctoks = self._index.toks.get(c, ())
                    while lcp < min(len(blk), len(ctoks)) \
                            and blk[lcp] == ctoks[lcp]:
                        lcp += 1
                    cand = c if lcp > 0 else None
        # pin resolved pages so eviction inside _alloc_pages can't free them
        for pid in shared_pids:
            self._pool.retain(pid)
        if cand is not None:
            self._pool.retain(cand)
        s = len(shared_pids)
        cov = s * P + lcp
        p0 = min(cov, Lp - 1)
        d0 = p0 // P
        use_shared = min(d0, s)
        priv = self._alloc_pages(need - use_shared)
        if priv is None:
            for pid in shared_pids:
                self._pool.release(pid)
            if cand is not None:
                self._pool.release(cand)
            return None
        row = shared_pids[:use_shared] + priv
        self._clear(priv)
        cow_src = None
        if d0 < s:
            cow_src = shared_pids[d0]     # whole prompt inside shared blocks
        elif lcp > 0:
            cow_src = cand                # divergence inside block d0
        if cow_src is not None:
            self._copy_page(cow_src, row[d0], p0)
        # drop the pins we are not keeping in the row
        for pid in shared_pids[use_shared:]:
            self._pool.release(pid)
        if cand is not None:
            self._pool.release(cand)
        return row, p0, hashes

    def _promote(self, st: _Slot) -> None:
        """Publish the slot's prompt-prefix pages into the shared index:
        full blocks become exact-match (``full``) and divergence-source
        (``nxt``) candidates; a trailing partial block a ``nxt`` candidate
        only.  Runs after prefill completes and before any immediate
        retirement."""
        if st.hashes is None or not self._share:
            return
        nfull = len(st.req.tokens) // self.page_size
        for j, (h_prev, h_self, blk) in enumerate(st.hashes):
            pid = int(st.pages[j]) if j < len(st.pages) else -1
            if pid <= 0:
                continue
            if j < nfull and self._index.add("full", h_self, pid):
                self._pool.retain(pid)
                self._index.toks.setdefault(pid, blk)
            if self._index.add("nxt", h_prev, pid):
                self._pool.retain(pid)
                self._index.toks.setdefault(pid, blk)

    # ----------------------------------------------------------- admission --
    def _finish(self, st: _Slot, slot: Optional[int] = None) -> Completion:
        t = time.perf_counter()
        self.telemetry.on_finish(st.req.rid, t)
        if self.paged:
            self._release_slot_pages(st)
            if slot is not None:
                # unmap the retired row now: a released page re-allocated
                # to another slot must never appear mapped in two rows
                self._set_table_row(slot, [])
        # pos always trails the generated count by prompt_tokens - 1
        return Completion(request=st.req, tokens=st.generated,
                          prompt_tokens=st.pos - len(st.generated) + 1,
                          latency_s=t - st.submit_t)

    def _timeout(self, req: Request, t0: float, t_sub: float) -> Completion:
        self.telemetry.on_finish(req.rid, t0)
        self.timeouts += 1
        return Completion(request=req, tokens=[],
                          prompt_tokens=len(req.tokens),
                          latency_s=t0 - t_sub, status="timeout")

    def _idle(self, slot: int) -> None:
        self._slots[slot] = None
        self._tok[slot] = 0
        self._pos[slot] = self._idle_pos
        self._seed[slot] = 0
        self._temp[slot] = 0.0

    def _activate(self, slot: int, st: _Slot, first_id: int,
                  done: List[Completion]) -> None:
        """Common tail of every admission path: record the prefill token
        and either retire immediately (budget 1 / instant eos) or join the
        decode batch."""
        st.generated = [first_id]
        st.prefilling = False
        self.telemetry.on_admit(st.req.rid, st.prompt_total, st.prefill_s)
        if self.paged:
            self._promote(st)
        if st.remaining == 0 or first_id == st.req.eos_id:
            self._idle(slot)
            done.append(self._finish(st, slot))
            return
        self._slots[slot] = st
        self._tok[slot] = first_id
        self._pos[slot] = st.pos
        self._seed[slot] = st.req.seed
        self._temp[slot] = st.req.temperature

    def _take_payload(self, pl) -> None:
        """Make a migrated payload's cache safe to read on this engine's
        stream: wait for the stream the channel handed it to (a payload
        re-homed from a dead engine was handed to that engine's), and mark
        its buffers as used here, so the caching allocator keeps them
        until the splice has read them."""
        if self.device.type != "cuda":
            return
        cur = torch.cuda.current_stream(self.device)
        src = getattr(pl, "_ready_on", None)
        if src is not None and src != cur:
            cur.wait_stream(src)
        for leaf in tree_leaves(pl.cache):
            leaf.record_stream(cur)

    def _admit_prefilled_paged(self, done: List[Completion]) -> None:
        while self._prefilled and self.free_slots > 0:
            pl = self._prefilled[0]
            req = pl.req
            head = int(getattr(pl, "head_pages", 0) or 0)
            if head > 0 and self.shared_head_pages(req.tokens) < head:
                # the promised shared head was evicted between the
                # sender's query and arrival: the payload alone cannot
                # rebuild the cache, so fall back to a full local prefill
                self._prefilled.popleft()
                self.prefix_fallbacks += 1
                self._queue.append(req)
                continue
            need = self._pages_needed(pl.prompt_tokens, req.max_new_tokens)
            shared = []
            if head > 0:
                hs = self._index.hashes(req.tokens)
                shared = [self._index.full[h] for _, h, _ in hs[:head]]
                for pid in shared:
                    self._pool.retain(pid)
            priv = self._alloc_pages(need - head)
            if priv is None:
                for pid in shared:
                    self._pool.release(pid)
                break                      # wait for a retirement
            self._prefilled.popleft()
            t0 = time.perf_counter()
            slot = self._slots.index(None)
            row = shared + priv
            self._set_table_row(slot, row)
            self._clear(priv)
            self._take_payload(pl)
            self._insert_paged(self._caches, pl.cache, 0, slot,
                               self._table_row_dev(slot))
            st = _Slot(req=req, pos=pl.prompt_tokens,
                       remaining=req.max_new_tokens - 1, generated=[],
                       submit_t=self.telemetry.submit_time(req.rid, t0),
                       pages=row, prompt_total=pl.prompt_tokens,
                       hashes=self._index.hashes(req.tokens)
                       if self._share and not req.extras else None,
                       prefill_s=time.perf_counter() - t0, t_admit=t0)
            self._slots[slot] = st
            self._activate(slot, st, pl.first_id, done)

    def _prefill_batch(self, items, done: List[Completion]) -> None:
        """One dense prefill dispatch for G same-length prompts, spliced
        row by row into the cache."""
        t0 = time.perf_counter()
        G = len(items)
        # extras requests are admitted one at a time (G == 1)
        logits, cache = self._prefill(np.stack([it[0].tokens
                                                for it in items]),
                                      items[0][0].extras)
        self.prefill_dispatches += 1
        pts = [len(it[0].tokens) + self._extra_tokens(it[0])
               for it in items]
        first = _pick_tokens(
            logits, np.asarray([p - 1 for p in pts], np.int32),
            np.asarray([it[0].seed for it in items], np.int32),
            np.asarray([it[0].temperature for it in items], np.float32))
        for r, (req, slot, row, hashes) in enumerate(items):
            if self.paged:
                self._insert_paged(self._caches, cache, r, slot,
                                   self._table_row_dev(slot))
            else:
                self._insert_dense(self._caches, cache, r, slot)
        first_host = first.cpu().numpy()
        prefill_s = (time.perf_counter() - t0) / G
        for r, (req, slot, row, hashes) in enumerate(items):
            st = _Slot(req=req, pos=pts[r],
                       remaining=req.max_new_tokens - 1, generated=[],
                       submit_t=self.telemetry.submit_time(req.rid, t0),
                       pages=row, prompt_total=pts[r], hashes=hashes,
                       prefill_s=prefill_s, t_admit=t0)
            self._slots[slot] = st
            self._activate(slot, st, int(first_host[r]), done)

    def _run_chunk(self, slot: int, st: _Slot, done: List[Completion]) -> None:
        """Advance one prefill chunk for an admitting slot; on the final
        chunk, emit the first token and join the decode batch."""
        L = len(st.req.tokens)
        C = self.chunk_prefill if self.chunk_prefill > 0 else L
        end = min(st.chunk_next + C, L)
        if L - end == 1:
            end = L            # merge a length-1 final chunk (C+1 tokens)
        t0 = time.perf_counter()
        toks = torch.as_tensor(st.req.tokens[st.chunk_next:end],
                               device=self.device)
        pos = torch.arange(st.chunk_next, end, dtype=torch.int32,
                           device=self.device)
        logits, _ = T.prefill_chunk(self.params, self.cfg, toks, pos,
                                    self._caches, slot,
                                    self._table_row_dev(slot),
                                    self.window_override)
        st.chunk_next = end
        if end < L:
            st.prefill_s += time.perf_counter() - t0
            return
        first = _pick_tokens(logits, np.asarray([L - 1], np.int32),
                             np.asarray([st.req.seed], np.int32),
                             np.asarray([st.req.temperature], np.float32))
        first_id = int(first[0])
        st.prefill_s += time.perf_counter() - t0
        self._activate(slot, st, first_id, done)

    def _admit_paged(self) -> List[Completion]:
        done: List[Completion] = []
        self._admit_prefilled_paged(done)
        batches: Dict[int, List[tuple]] = {}
        while self._queue and self.free_slots > 0:
            req = self._queue[0]
            t0 = time.perf_counter()
            t_sub = self.telemetry.submit_time(req.rid, t0)
            if req.deadline_s is not None and t0 - t_sub > req.deadline_s:
                self._queue.popleft()
                done.append(self._timeout(req, t0, t_sub))
                continue
            plan = self._plan_pages(req)
            if plan is None:
                break                      # pool exhausted: stay queued
            self._queue.popleft()
            row, p0, hashes = plan
            slot = self._slots.index(None)
            self._set_table_row(slot, row)
            L = len(req.tokens)
            Lp = L + self._extra_tokens(req)
            st = _Slot(req=req, pos=Lp, remaining=req.max_new_tokens - 1,
                       generated=[], submit_t=t_sub, pages=row,
                       prefilling=True, chunk_next=p0, prompt_total=Lp,
                       hashes=hashes, t_admit=t0)
            self._slots[slot] = st
            whole = p0 == 0 and (self.chunk_prefill <= 0
                                 or L <= self.chunk_prefill)
            if req.extras or (whole and not self.batch_prefill):
                self._prefill_batch([(req, slot, row, hashes)], done)
            elif whole:
                batches.setdefault(L, []).append((req, slot, row, hashes))
            else:
                self._reset_row(slot)
                if self.chunk_prefill <= 0 or L - p0 <= self.chunk_prefill:
                    self._run_chunk(slot, st, done)   # synchronous tail
                # else: the slot stays prefilling; step() advances one
                # chunk per engine step, interleaved with the decode batch
        for L, items in batches.items():
            self._prefill_batch(items, done)
        return done

    def _admit_dense(self) -> List[Completion]:
        done: List[Completion] = []
        # migrated payloads first: their prefill is already sunk on a
        # prefill GMI, so admission is the splice alone, the same one the
        # local path uses
        while self._prefilled and self.free_slots > 0:
            pl = self._prefilled.popleft()
            req = pl.req
            t0 = time.perf_counter()
            slot = self._slots.index(None)
            self._take_payload(pl)
            self._insert_dense(self._caches, pl.cache, 0, slot)
            st = _Slot(req=req, pos=pl.prompt_tokens,
                       remaining=req.max_new_tokens - 1, generated=[],
                       submit_t=self.telemetry.submit_time(req.rid, t0),
                       prompt_total=pl.prompt_tokens,
                       prefill_s=time.perf_counter() - t0, t_admit=t0)
            self._slots[slot] = st
            self._activate(slot, st, pl.first_id, done)
        while self._queue and self.free_slots > 0:
            req = self._queue.popleft()
            t0 = time.perf_counter()
            t_sub = self.telemetry.submit_time(req.rid, t0)
            if req.deadline_s is not None and t0 - t_sub > req.deadline_s:
                done.append(self._timeout(req, t0, t_sub))
                continue
            slot = self._slots.index(None)
            Lp = len(req.tokens) + self._extra_tokens(req)
            st = _Slot(req=req, pos=Lp,
                       remaining=req.max_new_tokens - 1, generated=[],
                       submit_t=t_sub, prompt_total=Lp, t_admit=t0)
            self._slots[slot] = st
            self._prefill_batch([(req, slot, [], None)], done)
        return done

    def step(self) -> List[Completion]:
        """Admit from the queue, advance chunked prefills, run ONE batched
        decode step, retire finished requests.  Returns this step's
        completions.  Runs under the GMI's stream."""
        with self.scope():
            return self._step()

    def _step(self) -> List[Completion]:
        if self.fault_hook is not None:
            try:
                self.fault_hook(self)
            except Exception as exc:
                # mid-decode death: slots are forfeit, the queue survives
                self.dead = True
                if getattr(exc, "engine", None) is None:
                    exc.engine = self
                raise
        if self.dead:
            raise RuntimeError(f"{self.name}: engine is dead")
        done = self._admit_paged() if self.paged else self._admit_dense()
        # advance ONE chunk for each slot still prefilling
        for i, st in enumerate(self._slots):
            if st is not None and st.prefilling:
                self._run_chunk(i, st, done)
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and not s.prefilling]
        if not active:
            return done
        # the token readback is the one host sync a step: continuous
        # batching needs the ids on the host to retire slots
        t0 = time.perf_counter()
        table = self._table_device() if self.paged else None
        tok = self._decode(self._caches,
                           torch.as_tensor(self._tok, device=self.device),
                           self._pos, self._seed, self._temp, table)
        tok_host = tok.cpu().numpy()
        dt = time.perf_counter() - t0
        emitted = 0
        for i in active:
            st = self._slots[i]
            tid = int(tok_host[i])
            st.generated.append(tid)
            st.pos += 1
            st.remaining -= 1
            emitted += 1
            if st.remaining == 0 or tid == st.req.eos_id:
                self._idle(i)
                done.append(self._finish(st, i))
            else:
                self._tok[i] = tid
                self._pos[i] = st.pos
        self.telemetry.on_step(dt, len(active), len(self._queue), emitted)
        return done

    def take_queue(self) -> List[Request]:
        """Remove and return every not-yet-admitted request."""
        out = list(self._queue)
        self._queue.clear()
        return out

    def take_inflight(self) -> List[Request]:
        """Remove and return the requests currently holding decode slots
        (including mid-chunked-prefill ones), abandoning their progress."""
        out = [s.req for s in self._slots if s is not None]
        if self.paged:
            for s in self._slots:
                if s is not None:
                    self._release_slot_pages(s)
            self._table[:] = -1
            self._table_dev = None
        for i in range(self.max_slots):
            self._idle(i)
        return out

    def run_until_idle(self, admit: bool = True) -> List[Completion]:
        """Step until queue and slots are empty.  ``admit=False`` finishes
        the in-flight slots only."""
        pending = [] if admit else self.take_queue()
        done: List[Completion] = []
        while self.busy:
            done.extend(self.step())
        self._queue.extend(pending)
        return done

    def serve(self, requests: List[Request]) -> List[Completion]:
        """Submit-and-drain convenience; completions in retire order."""
        for r in requests:
            self.submit(r)
        return self.run_until_idle()

    # -------------------------------------------------------------- oracle --
    def oracle_generate(self, req: Request) -> List[int]:
        """The single-request reference path: the same prefill, then B=1
        decode over a fresh private page pool (paged) or cache (dense).
        Continuous-batched greedy decoding must be token-identical to this
        (in f32; bf16 GEMMs at B=1 and B=8 may round differently)."""
        with self.scope():
            return self._oracle(req)

    def _oracle(self, req: Request) -> List[int]:
        logits, caches = self._prefill(req.tokens[None], req.extras)
        prompt_tokens = len(req.tokens) + self._extra_tokens(req)
        table = None
        if self.paged:
            M = self.pages_per_slot
            pool = T.init_paged_cache(self.cfg, 1, self.max_seq,
                                      self.window_override,
                                      T.torch_dtype(self.cfg),
                                      page_size=self.page_size,
                                      num_pages=M + 1, device=self.device)
            need = self._pages_needed(prompt_tokens, req.max_new_tokens)
            row = np.full((M,), -1, np.int32)
            row[:need] = np.arange(1, need + 1)
            table = torch.as_tensor(row[None], device=self.device)
            self._insert_paged(pool, caches, 0, 0, table[0])
            caches = pool
        seed = np.asarray([req.seed], np.int32)
        temp = np.asarray([req.temperature], np.float32)
        tok = _pick_tokens(logits, np.asarray([prompt_tokens - 1], np.int32),
                           seed, temp)
        out = [int(tok[0])]
        pos = prompt_tokens
        for _ in range(req.max_new_tokens - 1):
            if out[-1] == req.eos_id:
                break
            tok = self._decode(caches, tok, np.asarray([pos], np.int32),
                               seed, temp, table)
            out.append(int(tok[0]))
            pos += 1
        return out


def _pick_tokens(logits, pos, seed, temp):
    """Next-token choice shared by prefill, decode and the oracle.

    ``pos``, ``seed`` and ``temp`` are host arrays (B,).  Greedy rows take
    the argmax (first maximal index, as ``jnp.argmax``).  Sampled rows take
    a Gumbel-max draw: ``argmax(logits / temp + g)`` with ``g = -log(-log
    u)`` and ``u`` the 24-bit uniform of ``hash_u32(hash_u32(hash_u32(seed)
    ^ pos) + vocab index)``, so the draw depends only on (request seed,
    absolute position), never on batch composition, and its uniforms are
    bit-identical on the CPU and the card.  Returns (B,) int32 on the
    logits' device."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not (temp > 0.0).any():
        return greedy
    dev = logits.device
    V = logits.shape[-1]
    key = hash_u32(hash_u32(torch.as_tensor(seed, device=dev))
                   ^ torch.as_tensor(pos, device=dev).to(torch.int64))
    h = hash_u32((key[:, None] + torch.arange(V, device=dev)) & 0xFFFFFFFF)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / 16777216.0)
    g = -torch.log(-torch.log(u))
    t = torch.as_tensor(temp, device=dev)
    sampled = torch.argmax(logits.float() / torch.clamp(t, min=1e-6)[:, None]
                           + g, dim=-1).to(torch.int32)
    return torch.where(t > 0.0, sampled, greedy)
