"""SRAM-budget adapter cache: byte-accounted residency, LRU, pinning (the
port of ``repro/serving/adapters/cache.py``, without its tiered-memory
hooks, which wait for ``serving/memory``).

Models TOM's finite SRAM: adapters share the on-chip budget with the KV
cache, so only a bounded set can be resident at once. The cache tracks

  * **bytes** — every resident adapter is accounted at its packed 2-bit
    footprint (``qlora.adapter_bytes``); admission never exceeds the budget;
  * **slots** — each resident adapter owns one index in the device-side
    ``[num_adapters, ...]`` stacks (slot 0 is the null adapter and is never
    allocated);
  * **pins** — refcounts of in-flight requests. A pinned adapter is *never*
    evicted: its slot index is baked into running decode state;
  * **LRU** — unpinned residents evict least-recently-used first when a new
    adapter needs bytes or a slot.

Pure host-side control plane (the data plane lives in runtime.py), so it is
unit-testable without a model.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple


class AdapterCache:
    def __init__(self, budget_bytes: int, max_entries: int):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.budget_bytes = int(budget_bytes)
        self.max_entries = int(max_entries)
        self._slot: Dict[str, int] = {}        # id → device slot (1-based)
        self._nbytes: Dict[str, int] = {}
        self._pins: Dict[str, int] = {}
        self._last_use: Dict[str, int] = {}
        self._clock = itertools.count(1)
        self._free_slots: List[int] = list(range(max_entries, 0, -1))
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.loads = 0

    # -- introspection --------------------------------------------------------
    @property
    def bytes_used(self) -> int:
        return sum(self._nbytes.values())

    @property
    def n_resident(self) -> int:
        return len(self._slot)

    def is_resident(self, adapter_id: str) -> bool:
        return adapter_id in self._slot

    def slot_of(self, adapter_id: str) -> int:
        return self._slot[adapter_id]

    def pinned(self, adapter_id: str) -> bool:
        return self._pins.get(adapter_id, 0) > 0

    def resident_ids(self) -> List[str]:
        return list(self._slot)

    # -- admission ------------------------------------------------------------
    def _evictable_lru(self) -> List[str]:
        """Unpinned residents, least-recently-used first."""
        ids = [i for i in self._slot if self._pins.get(i, 0) == 0]
        return sorted(ids, key=lambda i: self._last_use.get(i, 0))

    def can_admit(self, adapter_id: str, nbytes: int) -> bool:
        """Could ``adapter_id`` be made resident *right now* (evicting only
        unpinned adapters)? Admission control calls this before scheduling a
        request whose adapter is cold."""
        if adapter_id in self._slot:
            return True
        if nbytes > self.budget_bytes:
            return False
        reclaimable = sum(self._nbytes[i] for i in self._evictable_lru())
        if self.bytes_used - reclaimable + nbytes > self.budget_bytes:
            return False
        if not self._free_slots and not self._evictable_lru():
            return False
        return True

    def lookup(self, adapter_id: str) -> Optional[int]:
        """Slot of a resident adapter (touches LRU + hit/miss counters)."""
        slot = self._slot.get(adapter_id)
        if slot is None:
            self.misses += 1
            return None
        self.hits += 1
        self._last_use[adapter_id] = next(self._clock)
        return slot

    def admit(self, adapter_id: str, nbytes: int) -> Tuple[int, List[str]]:
        """Make ``adapter_id`` resident; returns (slot, evicted ids). Raises
        MemoryError when pinned residents hold too much of the budget."""
        if adapter_id in self._slot:
            return self._slot[adapter_id], []
        evicted: List[str] = []
        while (self.bytes_used + nbytes > self.budget_bytes
               or not self._free_slots):
            lru = self._evictable_lru()
            if not lru:
                raise MemoryError(
                    f"adapter SRAM budget exhausted by pinned adapters "
                    f"({self.bytes_used}B used + {nbytes}B needed > "
                    f"{self.budget_bytes}B budget)")
            evicted.append(self._evict(lru[0]))
        slot = self._free_slots.pop()
        self._slot[adapter_id] = slot
        self._nbytes[adapter_id] = nbytes
        self._last_use[adapter_id] = next(self._clock)
        self.loads += 1
        return slot, evicted

    def _evict(self, adapter_id: str) -> str:
        self._free_slots.append(self._slot.pop(adapter_id))
        self._nbytes.pop(adapter_id)
        self._last_use.pop(adapter_id, None)
        self.evictions += 1
        return adapter_id

    # -- pinning (in-flight requests) ----------------------------------------
    def pin(self, adapter_id: str) -> None:
        if adapter_id not in self._slot:
            raise KeyError(f"cannot pin {adapter_id!r}: not resident")
        self._pins[adapter_id] = self._pins.get(adapter_id, 0) + 1

    def unpin(self, adapter_id: str) -> None:
        n = self._pins.get(adapter_id, 0)
        if n <= 1:
            self._pins.pop(adapter_id, None)
        else:
            self._pins[adapter_id] = n - 1

    # -- stats ----------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        lookups = self.hits + self.misses
        return {
            "resident": self.n_resident,
            "pinned": sum(1 for i in self._slot if self.pinned(i)),
            "bytes_used": self.bytes_used,
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / lookups, 4) if lookups else 0.0,
            "evictions": self.evictions,
            "loads": self.loads,
        }
