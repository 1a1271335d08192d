"""Page-pool KV cache and token-hash prefix cache — the port of
``paddle_tpu/serving/paged_kv.py:81-578``.

One preallocated ``[L, num_pages, page_size, nh, hd]`` K/V pair, fixed-size
pages handed out from a host-side free list, and a per-slot page table
(``[max_pages_per_slot]`` int32 of physical page ids) that the decode and
prefill passes receive as a plain int32 tensor. Long-context and short
traffic share device memory at page granularity; no shape ever changes.

Layout rules, as in the JAX package:

- **Page 0 is scratch**: pinned, never allocated, never read for a valid
  row. Unmapped table entries point at it, so bucket-padding rows written
  past a slot's mapping, and the rows of dead decode lanes, land there.
- A slot's pages are mapped in logical order; positions ``< length`` are
  always backed (``ensure_capacity`` maps the next page before the decode
  step that writes into it).
- **Sharing is append-safe**: shared pages are full prompt-prefix pages,
  and every write a slot performs lands at positions ``>= prefix_len``,
  in pages it owns alone.

The pools are updated in place by the engine (JAX swapped donated arrays
between executable calls). The prefix cache keys page-aligned prompt
prefixes by sha1 of their tokens (exact match verified), holds one
reference on every page of every entry, is LRU, and gives pages back
under pool pressure.

One divergence from the reference, on purpose: ``PagedKVCache.can_admit``
counts the pages a prefix-cache reclaim could free, as the reference's
docstring says. The reference wires its reclaimer as the bound method
``PrefixCache.reclaim``, which has no ``reclaimable`` attribute, so its
count is always 0 and a prompt that a reclaim would fit is never admitted
(ROADMAP.md, section C). Here the reclaimer is the ``PrefixCache`` itself:
``_take_pages`` calls its ``reclaim`` and ``can_admit`` its
``reclaimable``.

The KV handoff (``serving/kv_transfer.py``) moves page contents with
``read_pages`` / ``write_pages`` (on a tensor-parallel engine's driver,
``shard_io`` set, the all-heads layout gathered from and scattered to the
ranks' pools of ``local_heads`` heads each, as ``kv_cache.KVCache``'s
rows); the receiving side claims pages with one
reference each (``claim_pages``, ``paged_kv.py:313``), binds them to a slot
(``adopt_slot``, ``:362``) or registers them as a cached prefix
(``PrefixCache.adopt_nested``, ``:500``; ``PrefixCache.has``, ``:472``,
probes without counting).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import metrics as smetrics
from .kv_cache import CacheFullError

__all__ = ["PagedKVCache", "PrefixCache", "PagePoolFullError"]


class PagePoolFullError(RuntimeError):
    """No free page (after prefix-cache reclaim) — the scheduler defers
    admission or preempts; it does not crash."""


@dataclasses.dataclass
class _SlotState:
    live: bool = False
    length: int = 0          # valid prefix length (tokens written)
    prefix_len: int = 0      # leading tokens backed by shared pages
    mapped: int = 0          # logical pages currently mapped


class PagedKVCache:
    """Page-pool allocator + the two pooled caches (``k``, ``v``).

    Keeps the slab :class:`~.kv_cache.KVCache`'s contracts for the engine
    and the scheduler (``alloc``/``free``/``length``/``headroom``/
    ``occupancy``) and adds the paged surface: per-slot page tables,
    page-budget queries and refcounts shared with the prefix cache."""

    def __init__(self, num_layers: int, max_slots: int, max_seq: int,
                 num_heads: int, head_dim: int, dtype=torch.float32,
                 page_size: int = 8, num_pages: int = 0, device="cuda",
                 shards: int = 1):
        if max_slots < 1 or max_seq < 1:
            raise ValueError("max_slots and max_seq must be >= 1")
        if page_size < 1 or max_seq % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_seq {max_seq}")
        dev = resolve_device(device)
        self.num_layers = int(num_layers)
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.num_heads = int(num_heads)
        self.local_heads = self.num_heads // int(shards)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        # the tp driver's channel to the other ranks' pools (serving/tp.py)
        self.shard_io = None
        self.page_size = int(page_size)
        self.max_pages_per_slot = self.max_seq // self.page_size
        # default pool = slab parity (+1 scratch page): the same worst
        # case, but pages bind to slots only as sequences grow
        self.num_pages = int(num_pages) or (
            self.max_slots * self.max_pages_per_slot + 1)
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is scratch)")
        shape = (self.num_layers, self.num_pages, self.page_size,
                 self.local_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=dev)
        self.v = torch.zeros(shape, dtype=dtype, device=dev)
        self._tables = np.zeros((self.max_slots, self.max_pages_per_slot),
                                np.int32)           # 0 = scratch/unmapped
        self._slots = [_SlotState() for _ in range(self.max_slots)]
        self._free_slots: List[int] = list(range(self.max_slots))
        self._ref = np.zeros((self.num_pages,), np.int64)
        self._ref[0] = 1                             # scratch: pinned
        self._free_pages: List[int] = list(range(1, self.num_pages))
        # set by the engine: the PrefixCache (reclaim(n) -> pages freed,
        # reclaimable() -> pages a full reclaim could free)
        self.reclaimer: Optional["PrefixCache"] = None

    # -- geometry ----------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to back ``n_tokens`` cache rows."""
        return -(-int(n_tokens) // self.page_size)

    @property
    def nbytes(self) -> int:
        return int(self.k.numel() + self.v.numel()) * self.k.element_size()

    # -- page plumbing -----------------------------------------------------
    def free_page_count(self) -> int:
        return len(self._free_pages)

    def _take_pages(self, n: int) -> List[int]:
        if n > len(self._free_pages) and self.reclaimer is not None:
            self.reclaimer.reclaim(n - len(self._free_pages))
        if n > len(self._free_pages):
            raise PagePoolFullError(
                f"need {n} free page(s), have {len(self._free_pages)} "
                f"of {self.num_pages}")
        out = [self._free_pages.pop(0) for _ in range(n)]
        for p in out:
            if self._ref[p] != 0:
                raise RuntimeError(f"free page {p} had refs")
            self._ref[p] = 1
        return out

    def ref_pages(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == 0 or self._ref[p] <= 0:
                raise RuntimeError(f"ref on dead page {p}")
            self._ref[p] += 1

    def deref_pages(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == 0:
                continue
            if self._ref[p] <= 0:
                raise RuntimeError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free_pages.append(p)
        self._free_pages.sort()
        self._note_pool_metrics()

    # -- slot bookkeeping --------------------------------------------------
    def can_admit(self, prompt_len: int, prefix_len: int = 0) -> bool:
        """Would a prompt of ``prompt_len``, ``prefix_len`` tokens of it
        already backed by cached pages, fit right now, a slot and all of
        its own pages? The cached prefix's whole pages need no new ones
        (``paddle_tpu/serving/paged_kv.py:183-193``). Counts the pages a
        prefix-cache reclaim could free."""
        if not self._free_slots:
            return False
        need = self.pages_for(prompt_len) - prefix_len // self.page_size
        avail = len(self._free_pages)
        if self.reclaimer is not None:
            avail += self.reclaimer.reclaimable()
        return need <= avail

    def alloc(self, length: int = 0,
              prefix_pages: Sequence[int] = ()) -> int:
        """Claim a slot; attach ``prefix_pages`` (shared, refcounted) and
        map fresh pages so every position ``< length`` is backed.

        Raises :class:`CacheFullError` when no slot is free and
        :class:`PagePoolFullError` when the pool is dry (the slot is NOT
        claimed then)."""
        if not self._free_slots:
            raise CacheFullError(
                f"all {self.max_slots} decode slots are live")
        if length > self.max_seq:
            raise ValueError(
                f"sequence length {length} exceeds max_seq {self.max_seq}")
        n_prefix = len(prefix_pages)
        if n_prefix * self.page_size > length:
            raise ValueError("prefix pages cover more than the sequence")
        n_own = self.pages_for(length) - n_prefix
        # pin the shared prefix FIRST: _take_pages may run the prefix
        # cache's reclaim, which must not free (and recycle) the very
        # pages this slot is about to attach
        self.ref_pages(prefix_pages)
        try:
            own = self._take_pages(n_own)
        except PagePoolFullError:
            self.deref_pages(prefix_pages)
            raise
        slot = self._free_slots.pop(0)
        st = self._slots[slot]
        st.live = True
        st.length = int(length)
        st.prefix_len = n_prefix * self.page_size
        st.mapped = n_prefix + n_own
        row = self._tables[slot]
        row[:] = 0
        row[:n_prefix] = prefix_pages
        row[n_prefix:st.mapped] = own
        self._note_pool_metrics()
        return slot

    def ensure_capacity(self, slot: int, upto_len: int) -> bool:
        """Map pages so positions ``< upto_len`` are write-backed. Returns
        False (mapping nothing) when the pool cannot cover it — the
        scheduler's cue to preempt."""
        st = self._slots[slot]
        if not st.live:
            raise ValueError(f"slot {slot} is not live")
        if upto_len > self.max_seq:
            return False
        need = self.pages_for(upto_len) - st.mapped
        if need <= 0:
            return True
        try:
            pages = self._take_pages(need)
        except PagePoolFullError:
            return False
        self._tables[slot][st.mapped:st.mapped + need] = pages
        st.mapped += need
        self._note_pool_metrics()
        return True

    def free(self, slot: int) -> None:
        st = self._slots[slot]
        if not st.live:
            raise ValueError(f"slot {slot} is not live")
        row = self._tables[slot]
        self.deref_pages([int(p) for p in row[:st.mapped]])
        row[:] = 0
        st.live = False
        st.length = 0
        st.prefix_len = 0
        st.mapped = 0
        self._free_slots.append(slot)
        self._free_slots.sort()

    def set_length(self, slot: int, length: int) -> None:
        st = self._slots[slot]
        if length > self.max_seq:
            raise ValueError(
                f"slot {slot}: length {length} exceeds max_seq "
                f"{self.max_seq}")
        if self.pages_for(length) > st.mapped:
            raise ValueError(
                f"slot {slot}: length {length} beyond mapped pages "
                f"({st.mapped} x {self.page_size})")
        st.length = int(length)

    def length(self, slot: int) -> int:
        return self._slots[slot].length

    def is_live(self, slot: int) -> bool:
        return self._slots[slot].live

    def live_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s.live]

    def free_slot_count(self) -> int:
        return len(self._free_slots)

    @property
    def occupancy(self) -> float:
        return (self.max_slots - len(self._free_slots)) / self.max_slots

    def headroom(self, slot: int) -> int:
        return self.max_seq - self._slots[slot].length

    # -- page contents -----------------------------------------------------
    def claim_pages(self, n: int) -> List[int]:
        """Take ``n`` pages off the free list with ONE reference each — the
        slot's reference after :meth:`adopt_slot`, or the prefix cache's
        after ``PrefixCache.adopt_nested``. Raises
        :class:`PagePoolFullError` (after the reclaimer) when the pool
        cannot cover it."""
        return self._take_pages(int(n))

    def adopt_slot(self, length: int, pages: Sequence[int]) -> int:
        """Bind claimed, already-written ``pages`` to a fresh slot with
        ``length`` valid positions — the receiving half of a KV handoff.
        The pages' single reference (:meth:`claim_pages`) becomes the
        slot's, so :meth:`free` returns them to the pool. Raises
        :class:`CacheFullError` when no slot is free (the caller still owns
        the pages and must deref them)."""
        pages = [int(p) for p in pages]
        if length > self.max_seq:
            raise ValueError(
                f"sequence length {length} exceeds max_seq {self.max_seq}")
        if len(pages) != self.pages_for(length):
            raise ValueError(
                f"adopting {len(pages)} page(s) for length {length}; "
                f"need {self.pages_for(length)}")
        for p in pages:
            if p == 0 or self._ref[p] <= 0:
                raise ValueError(f"adopting unclaimed page {p}")
        if not self._free_slots:
            raise CacheFullError(
                f"all {self.max_slots} decode slots are live")
        slot = self._free_slots.pop(0)
        st = self._slots[slot]
        st.live = True
        st.length = int(length)
        st.prefix_len = 0
        st.mapped = len(pages)
        row = self._tables[slot]
        row[:] = 0
        row[:len(pages)] = pages
        self._note_pool_metrics()
        return slot

    def read_pages(self, pages: Sequence[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host copies of the K/V contents of ``pages``: ``([L, n, page,
        nh, hd] k, the same for v)``, one gather and one copy."""
        pages = [int(p) for p in pages]
        if self.shard_io is not None:
            return self.shard_io.read("_read_pages_local", (pages,), axis=3)
        return self._read_pages_local(pages)

    def write_pages(self, pages: Sequence[int], k_pages,
                    v_pages) -> None:
        """Write K/V contents (``[L, n, page, nh, hd]``, tensors or numpy
        arrays) into ``pages``, in place."""
        pages = [int(p) for p in pages]
        k_pages = torch.as_tensor(k_pages)
        v_pages = torch.as_tensor(v_pages)
        if self.shard_io is not None:
            self.shard_io.write("_write_pages_local", (pages,), k_pages,
                                v_pages, axis=3)
        else:
            self._write_pages_local(pages, k_pages, v_pages)

    # this rank's heads alone
    def _read_pages_local(self, pages):
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.k.device)
        kv = torch.stack((self.k[:, idx], self.v[:, idx])).cpu()
        return kv[0], kv[1]

    def _write_pages_local(self, pages, k_pages, v_pages) -> None:
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.k.device)
        kv = torch.stack((k_pages, v_pages)).to(self.k)
        self.k[:, idx] = kv[0]
        self.v[:, idx] = kv[1]

    # -- decode feeds ------------------------------------------------------
    def table_row(self, slot: int) -> np.ndarray:
        """[max_pages_per_slot] int32 page table of one slot (a copy)."""
        return self._tables[slot].copy()

    def tables(self) -> np.ndarray:
        """[max_slots, max_pages_per_slot] int32 — the decode feed."""
        return self._tables.copy()

    # -- pool metrics ------------------------------------------------------
    def pool_occupancy(self) -> float:
        """Allocated pages / allocatable pages (scratch excluded)."""
        total = self.num_pages - 1
        return (total - len(self._free_pages)) / total

    def fragmentation(self) -> float:
        """Internal waste: 1 - used rows / allocated rows. Cache-held
        shared pages are full by construction and count as used."""
        mapped = sum(s.mapped for s in self._slots if s.live)
        cache_held = max(int(np.sum(self._ref[1:] > 0)) - mapped, 0)
        allocated_rows = (mapped + cache_held) * self.page_size
        used_rows = (sum(s.length for s in self._slots if s.live)
                     + cache_held * self.page_size)
        if allocated_rows <= 0:
            return 0.0
        return 1.0 - used_rows / allocated_rows

    def _note_pool_metrics(self) -> None:
        smetrics.m_page_occupancy.set(self.pool_occupancy())
        smetrics.m_page_fragmentation.set(self.fragmentation())


class PrefixCache:
    """Token-hash keyed, refcounted, LRU prefix cache over a page pool.

    Entries are page-aligned prompt prefixes; the cache holds ONE ref on
    every page of every entry (slots using the pages hold their own).
    ``capacity_pages`` bounds the distinct cache-held pages; LRU entries
    drop on overflow and under pool pressure (:meth:`reclaim`)."""

    def __init__(self, pool: PagedKVCache, capacity_pages: int = 0):
        self.pool = pool
        self.capacity_pages = int(capacity_pages) or pool.num_pages
        # use-ordered: key -> (tokens tuple, pages tuple)
        self._entries: "OrderedDict[bytes, Tuple[Tuple[int, ...], Tuple[int, ...]]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(tokens: Sequence[int]) -> bytes:
        return hashlib.sha1(
            np.asarray(tokens, np.int64).tobytes()).digest()

    def _held_pages(self) -> set:
        held = set()
        for _, pages in self._entries.values():
            held.update(pages)
        return held

    def held_page_count(self) -> int:
        return len(self._held_pages())

    def reclaimable(self) -> int:
        """Pages a full reclaim could hand back to the pool (those only
        the cache still holds)."""
        return sum(1 for p in self._held_pages() if self.pool._ref[p] == 1)

    def has(self, tokens: Sequence[int]) -> bool:
        """Exact-entry probe WITHOUT metric counts or LRU freshening — the
        prefix index's "is it already here?" check."""
        prefix = tuple(int(t) for t in tokens)
        ent = self._entries.get(self._key(prefix))
        return ent is not None and ent[0] == prefix

    def adopt_nested(self, tokens: Sequence[int],
                     pages: Sequence[int]) -> int:
        """Register an adopted page-aligned prefix: ``pages`` already hold
        their single cache reference (:meth:`PagedKVCache.claim_pages`) and
        their contents. As :meth:`insert` publishes, every page-boundary
        prefix of ``tokens`` becomes an entry sharing those pages. Returns
        how many entries were registered (existing keys are skipped)."""
        ps = self.pool.page_size
        pages = tuple(int(p) for p in pages)
        if len(tokens) < len(pages) * ps:
            raise ValueError("adopted pages cover more than the tokens")
        registered = 0
        for j in range(1, len(pages) + 1):
            prefix = tuple(int(t) for t in tokens[:j * ps])
            key = self._key(prefix)
            if key in self._entries:
                continue
            self._entries[key] = (prefix, pages[:j])
            registered += 1
        self._evict_over_capacity()
        return registered

    def lookup(self, tokens: Sequence[int]
               ) -> Tuple[int, Tuple[int, ...]]:
        """Longest cached page-aligned prefix of ``tokens`` that leaves at
        least one suffix token to prefill: ``(prefix_len, pages)``, or
        ``(0, ())`` on a miss. Counts the hit/miss metric and freshens the
        LRU order on a hit."""
        ps = self.pool.page_size
        max_j = (len(tokens) - 1) // ps
        for j in range(max_j, 0, -1):
            prefix = tuple(int(t) for t in tokens[:j * ps])
            key = self._key(prefix)
            ent = self._entries.get(key)
            if ent is not None and ent[0] == prefix:
                self._entries.move_to_end(key)
                self.hits += 1
                smetrics.m_prefix_cache.labels("hit").inc()
                return j * ps, ent[1]
        self.misses += 1
        smetrics.m_prefix_cache.labels("miss").inc()
        return 0, ()

    def insert(self, tokens: Sequence[int], table_row: np.ndarray) -> int:
        """Publish every page-boundary prefix of ``tokens`` whose pages are
        in ``table_row`` (the slot's mapping after prefill). Returns how
        many NEW entries were added; new pages get one cache ref."""
        ps = self.pool.page_size
        full = len(tokens) // ps
        added = 0
        newly_held = []
        held = self._held_pages()
        for j in range(1, full + 1):
            prefix = tuple(int(t) for t in tokens[:j * ps])
            key = self._key(prefix)
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            pages = tuple(int(p) for p in table_row[:j])
            if any(p == 0 for p in pages):
                break                      # unmapped — nothing cacheable
            self._entries[key] = (prefix, pages)
            added += 1
            for p in pages:
                if p not in held:
                    held.add(p)
                    newly_held.append(p)
        if newly_held:
            self.pool.ref_pages(newly_held)
        self._evict_over_capacity()
        return added

    def _drop_entry(self, key: bytes) -> None:
        _tokens, pages = self._entries.pop(key)
        still_held = self._held_pages()
        self.pool.deref_pages([p for p in pages if p not in still_held])

    def _evict_over_capacity(self) -> None:
        while (self._entries
               and self.held_page_count() > self.capacity_pages):
            self._drop_entry(next(iter(self._entries)))

    def reclaim(self, n_pages: int) -> int:
        """Pool-pressure hook: drop LRU entries until ``n_pages`` pages
        went back to the free list (or the cache is empty). Returns the
        pages actually freed."""
        freed0 = self.pool.free_page_count()
        while (self._entries
               and self.pool.free_page_count() - freed0 < n_pages):
            self._drop_entry(next(iter(self._entries)))
        return self.pool.free_page_count() - freed0

    def clear(self) -> None:
        while self._entries:
            self._drop_entry(next(iter(self._entries)))

    def __len__(self) -> int:
        return len(self._entries)
