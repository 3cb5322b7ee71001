"""Fragmentation-aware device-allocator simulator.

The paper's Table 4 attributes the baseline's long-sequence slowdown to
memory *defragmentation events* (57 → 0 with hierarchical memory). We model
the device allocator as a first-fit free-list over a fixed HBM address
space: allocations at tensor birth, frees at death. When a request fails
although total free bytes suffice (external fragmentation), the allocator
performs a *compaction* — one defragmentation event with a cost proportional
to the live bytes moved. Replaying the same op trace with HyperOffload's
offloading (smaller residency) eliminates the failures, reproducing the
57→0 behaviour qualitatively and its latency consequence quantitatively.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class AllocStats:
    defrag_events: int = 0
    oom_events: int = 0
    bytes_moved: int = 0            # total live bytes copied during compactions
    high_water: int = 0


class FirstFitAllocator:
    """First-fit free-list allocator with compaction on fragmentation."""

    def __init__(self, capacity: int, alignment: int = 512) -> None:
        self.capacity = int(capacity)
        self.alignment = alignment
        self.blocks: Dict[str, Tuple[int, int]] = {}   # name -> (offset, size)
        self.stats = AllocStats()

    # ------------------------------------------------------------------
    def _aligned(self, size: int) -> int:
        a = self.alignment
        return -(-size // a) * a

    def _free_intervals(self) -> List[Tuple[int, int]]:
        """Sorted (offset, size) free gaps."""
        used = sorted(self.blocks.values())
        gaps: List[Tuple[int, int]] = []
        cur = 0
        for off, size in used:
            if off > cur:
                gaps.append((cur, off - cur))
            cur = max(cur, off + size)
        if cur < self.capacity:
            gaps.append((cur, self.capacity - cur))
        return gaps

    def free_bytes(self) -> int:
        return self.capacity - sum(s for _, s in self.blocks.values())

    def live_bytes(self) -> int:
        return sum(s for _, s in self.blocks.values())

    # ------------------------------------------------------------------
    def alloc(self, name: str, size: int) -> bool:
        """Returns True on success; counts defrag/OOM events internally."""
        if name in self.blocks:
            raise ValueError(f"double alloc of {name}")
        size = self._aligned(size)
        if size == 0:
            self.blocks[name] = (0, 0)
            return True
        for off, gap in self._free_intervals():
            if gap >= size:
                self.blocks[name] = (off, size)
                self.stats.high_water = max(self.stats.high_water, self.live_bytes())
                return True
        # no contiguous gap — fragmentation or true OOM?
        if self.free_bytes() >= size:
            self._compact()
            self.stats.defrag_events += 1
            return self.alloc_after_compact(name, size)
        self.stats.oom_events += 1
        return False

    def alloc_after_compact(self, name: str, size: int) -> bool:
        for off, gap in self._free_intervals():
            if gap >= size:
                self.blocks[name] = (off, size)
                self.stats.high_water = max(self.stats.high_water, self.live_bytes())
                return True
        self.stats.oom_events += 1
        return False

    def _compact(self) -> None:
        cur = 0
        for name in sorted(self.blocks, key=lambda n: self.blocks[n][0]):
            off, size = self.blocks[name]
            if off != cur:
                self.stats.bytes_moved += size
            self.blocks[name] = (cur, size)
            cur += size

    def free(self, name: str) -> None:
        self.blocks.pop(name, None)


def replay(events: Sequence[Tuple[int, str, str]],
           sizes: Dict[str, int], capacity: int,
           alignment: int = 512) -> AllocStats:
    """Replay a memsim event trace ((pos, 'alloc'|'free', tensor)) through
    the allocator and return fragmentation statistics."""
    a = FirstFitAllocator(capacity, alignment)
    for _, op, tensor in events:
        if op == "alloc":
            a.alloc(tensor, sizes[tensor])
        else:
            a.free(tensor)
    return a.stats
