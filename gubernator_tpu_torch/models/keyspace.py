"""Host key directory: string key -> device table slot.

The reference stores buckets in a per-key LRU of Go structs
(reference: cache.go:53-165). Here the bucket state is dense device memory,
and the only per-key host structure is this directory mapping keys to row
indices, with LRU recycling when the table is full. Losing a slot loses that
key's state — the same accepted tradeoff as the reference's LRU eviction and
restart behavior (reference: architecture.md:5-11).

A copy of the JAX package's pure-Python directory (models/keyspace.py
there), so both engines assign the same slots to the same key stream. The
JAX package's C++ directory (native/keydir.cpp) has no counterpart here yet.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple


class KeyDirectory:
    """LRU map key -> slot over a fixed slot capacity."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._map: "OrderedDict[str, int]" = OrderedDict()
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def lookup_inject(self, keys: Sequence[str], inject=None):
        """Native-API twin: (slots, fresh, inject). The python directory
        has no row mirrors (the native lone-request fast path lives in
        keydir.cpp), so the inject list is always empty and a caller's
        `inject` array is never written."""
        slots, fresh = self.lookup(keys)
        import numpy as np

        return slots, fresh, np.empty((0, 8), np.int64)

    def lookup(self, keys: Sequence[str]) -> Tuple[List[int], List[bool]]:
        """Map keys to slots, assigning (and recycling LRU) as needed.

        Returns (slots, fresh) where fresh[i] means the slot was newly
        assigned to keys[i] and its device row must be treated as vacant.
        Duplicate keys in one call share a slot; only the first sees fresh.

        Keys of the current call are pinned: eviction never recycles a slot
        handed out earlier in the same call, so one kernel round never
        scatters two lanes to one row. Callers must keep
        len(set(keys)) <= capacity (the engine chunks accordingly).
        """
        slots: List[int] = []
        fresh: List[bool] = []
        pinned = set()
        for key in keys:
            slot = self._map.get(key)
            if slot is not None:
                self._map.move_to_end(key)
                pinned.add(key)
                slots.append(slot)
                fresh.append(False)
                continue
            if self._free:
                slot = self._free.pop()
            else:
                slot = None
                for victim in self._map:  # LRU order; skip this call's keys
                    if victim not in pinned:
                        slot = self._map.pop(victim)
                        self.evictions += 1
                        break
                if slot is None:
                    raise RuntimeError(
                        f"key directory over-committed: >{self.capacity} "
                        "distinct keys in one lookup")
            self._map[key] = slot
            pinned.add(key)
            slots.append(slot)
            fresh.append(True)
        return slots, fresh

    def drop(self, key: str) -> None:
        """Forget a key, returning its slot to the free list."""
        slot = self._map.pop(key, None)
        if slot is not None:
            self._free.append(slot)

    def keys(self) -> List[str]:
        return list(self._map.keys())

    def items(self) -> List[Tuple[str, int]]:
        return list(self._map.items())

    def peek_slot(self, key: str) -> int:
        """Slot for key without recency effects; -1 if absent."""
        return self._map.get(key, -1)
