"""Preallocated slot-major KV cache — the port of
``paddle_tpu/serving/kv_cache.py`` (slab layout).

One slab per projection, ``[num_layers, max_slots, max_seq, nh, hd]``,
allocated once when the engine starts. The engine updates the slabs IN
PLACE (the JAX engine threaded them through every executable with buffer
donation to the same effect), so steady-state serving never allocates.

What this class owns besides the tensors is the host truth the scheduler
plans against: which slots are live, how long each slot's valid prefix
is, and a per-slot generation counter that makes slot reuse visible.
``read_rows`` / ``write_rows`` move a slot's rows ``[start, start + n)``
of every layer between the slabs and the host, one chunk at a time: the
slab layout's side of the KV handoff (``serving/kv_transfer.py``
``export_slot`` / ``adopt_into_engine``).

A tensor-parallel engine (``serving/tp.py``) gives each rank a cache of
``shards`` ways: its slabs hold the rank's ``num_heads / shards`` heads
(``local_heads``) while ``num_heads`` stays the model's. On the driver
rank ``shard_io`` is set, and ``read_rows`` / ``write_rows`` read and
write the all-heads layout, gathered from and scattered to the ranks, as
the reference's head-sharded arrays read whole.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["KVCache", "CacheFullError"]


class CacheFullError(RuntimeError):
    """All slots are occupied (the scheduler should queue, not crash)."""


@dataclasses.dataclass
class _SlotState:
    live: bool = False
    length: int = 0          # valid prefix length (tokens written)
    generation: int = 0      # bumped on every alloc


class KVCache:
    """Slot allocator + the two cache slabs (``k``, ``v``)."""

    def __init__(self, num_layers: int, max_slots: int, max_seq: int,
                 num_heads: int, head_dim: int, dtype=torch.float32,
                 device="cuda", shards: int = 1):
        if max_slots < 1 or max_seq < 1:
            raise ValueError("max_slots and max_seq must be >= 1")
        dev = resolve_device(device)
        self.num_layers = int(num_layers)
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.num_heads = int(num_heads)
        self.local_heads = self.num_heads // int(shards)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        # the tp driver's channel to the other ranks' slabs (serving/tp.py)
        self.shard_io = None
        shape = (num_layers, max_slots, max_seq, self.local_heads,
                 head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=dev)
        self.v = torch.zeros(shape, dtype=dtype, device=dev)
        self._slots = [_SlotState() for _ in range(max_slots)]
        self._free: List[int] = list(range(max_slots))

    @property
    def nbytes(self) -> int:
        return int(self.k.numel() + self.v.numel()) * self.k.element_size()

    def alloc(self, length: int = 0) -> int:
        """Claim a free slot (lowest index first); raises
        :class:`CacheFullError` when none is free."""
        if not self._free:
            raise CacheFullError(
                f"all {self.max_slots} KV-cache slots are live")
        if length > self.max_seq:
            raise ValueError(
                f"sequence length {length} exceeds max_seq {self.max_seq}")
        slot = self._free.pop(0)
        st = self._slots[slot]
        st.live = True
        st.length = int(length)
        st.generation += 1
        return slot

    def free(self, slot: int) -> None:
        st = self._slots[slot]
        if not st.live:
            raise ValueError(f"slot {slot} is not live")
        st.live = False
        st.length = 0
        self._free.append(slot)
        self._free.sort()

    def set_length(self, slot: int, length: int) -> None:
        if length > self.max_seq:
            raise ValueError(
                f"slot {slot}: length {length} exceeds max_seq "
                f"{self.max_seq}")
        self._slots[slot].length = int(length)

    def length(self, slot: int) -> int:
        return self._slots[slot].length

    def generation(self, slot: int) -> int:
        return self._slots[slot].generation

    def is_live(self, slot: int) -> bool:
        return self._slots[slot].live

    def live_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s.live]

    def free_slot_count(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        return (self.max_slots - len(self._free)) / self.max_slots

    def lengths_vector(self) -> np.ndarray:
        """[max_slots] int32 of valid prefix lengths (0 for dead slots)."""
        return np.array([s.length if s.live else 0 for s in self._slots],
                        np.int32)

    def headroom(self, slot: int) -> int:
        """Tokens this slot can still grow by before hitting max_seq."""
        return self.max_seq - self._slots[slot].length

    # -- row content I/O (serving/kv_transfer.py handoff) ------------------
    def _check_window(self, what: str, start: int, n: int) -> None:
        if start < 0 or n < 0 or start + n > self.max_seq:
            raise ValueError(
                f"{what} window [{start}, {start + n}) exceeds max_seq "
                f"{self.max_seq}")

    def read_rows(self, slot: int, start: int, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host copies of ``n`` cache rows of ``slot`` from position
        ``start``: ``([L, n, nh, hd] k, the same for v)`` — the slab
        analogue of :meth:`PagedKVCache.read_pages`, chunk-sized so a KV
        handoff never copies a whole slot at once."""
        self._check_window("read_rows", start, n)
        if self.shard_io is not None:
            return self.shard_io.read("_read_rows_local", (slot, start, n),
                                      axis=2)
        return self._read_rows_local(slot, start, n)

    def write_rows(self, slot: int, start: int, k_rows, v_rows) -> None:
        """Write transferred K/V rows (``[L, n, nh, hd]``, tensors or numpy
        arrays) into ``slot`` from position ``start``, in place."""
        k_rows = torch.as_tensor(k_rows)
        v_rows = torch.as_tensor(v_rows)
        self._check_window("write_rows", start, int(k_rows.shape[1]))
        if self.shard_io is not None:
            self.shard_io.write("_write_rows_local", (slot, start), k_rows,
                                v_rows, axis=2)
        else:
            self._write_rows_local(slot, start, k_rows, v_rows)

    # this rank's heads alone
    def _read_rows_local(self, slot, start, n):
        rows = slice(int(start), int(start) + int(n))
        kv = torch.stack((self.k[:, slot, rows], self.v[:, slot, rows]))
        kv = kv.to("cpu", copy=True)
        return kv[0], kv[1]

    def _write_rows_local(self, slot, start, k_rows, v_rows) -> None:
        rows = slice(int(start), int(start) + int(k_rows.shape[1]))
        self.k[:, slot, rows] = k_rows.to(self.k)
        self.v[:, slot, rows] = v_rows.to(self.v)
