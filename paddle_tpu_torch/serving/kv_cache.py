"""Preallocated slot-major KV cache — the port of
``paddle_tpu/serving/kv_cache.py`` (slab layout).

One slab per projection, ``[num_layers, max_slots, max_seq, nh, hd]``,
allocated once when the engine starts. The engine updates the slabs IN
PLACE (the JAX engine threaded them through every executable with buffer
donation to the same effect), so steady-state serving never allocates.

What this class owns besides the tensors is the host truth the scheduler
plans against: which slots are live, how long each slot's valid prefix
is, and a per-slot generation counter that makes slot reuse visible.
The transfer-path row I/O of the JAX class belongs to the KV handoff and
is still to be ported.
"""
from __future__ import annotations

import dataclasses
from typing import List

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
                 device="cuda"):
        if max_slots < 1 or max_seq < 1:
            raise ValueError("max_slots and max_seq must be >= 1")
        dev = resolve_device(device)
        self.num_layers = int(num_layers)
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        shape = (num_layers, max_slots, max_seq, num_heads, head_dim)
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
