"""Tensor lifetime analysis over an execution order (§4.2.2).

For each tensor: producer position, consumer positions, the *lifetime gap*
structure (intervals between consecutive uses where the tensor is resident
but idle), and the free position (where a non-persistent tensor dies).
The insertion pass uses gaps to pick offload candidates: a tensor is worth
parking in the remote pool iff some idle interval is long enough to amortize
a round-trip transfer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.ir import Graph


@dataclass(frozen=True)
class Lifetime:
    tensor: str
    nbytes: int
    klass: str
    producer_pos: Optional[int]      # None for graph inputs (weights/states)
    use_positions: Tuple[int, ...]   # sorted positions of reading nodes
    free_pos: Optional[int]          # position after which it can be freed

    @property
    def first_use(self) -> Optional[int]:
        return self.use_positions[0] if self.use_positions else None

    @property
    def last_use(self) -> Optional[int]:
        return self.use_positions[-1] if self.use_positions else None

    def idle_gaps(self) -> List[Tuple[int, int]]:
        """(start_pos, end_pos) intervals where the tensor is resident but
        unused: birth→first use and between consecutive uses."""
        gaps: List[Tuple[int, int]] = []
        birth = self.producer_pos if self.producer_pos is not None else -1
        prev = birth
        for u in self.use_positions:
            if u - prev > 1:
                gaps.append((prev, u))
            prev = u
        return gaps

    def longest_gap(self) -> Tuple[int, int]:
        gaps = self.idle_gaps()
        if not gaps:
            return (0, 0)
        return max(gaps, key=lambda g: g[1] - g[0])


def analyze(graph: Graph, order: Optional[Sequence[str]] = None) -> Dict[str, Lifetime]:
    """Lifetime of every tensor under ``order`` (cache ops excluded from
    'uses' — only compute reads count as uses)."""
    order = list(order) if order is not None else graph.order()
    pos = {n: i for i, n in enumerate(order)}
    producer: Dict[str, Optional[int]] = {t: None for t in graph.tensors}
    uses: Dict[str, List[int]] = {t: [] for t in graph.tensors}
    for name in order:
        node = graph.nodes[name]
        if node.kind != "compute":
            continue
        for t in node.outputs:
            if producer[t] is None:
                producer[t] = pos[name]
        for t in node.inputs:
            uses[t].append(pos[name])
    out: Dict[str, Lifetime] = {}
    for t, info in graph.tensors.items():
        u = tuple(sorted(uses[t]))
        persistent = info.klass in ("weight", "state")
        free = None if persistent or not u else u[-1]
        out[t] = Lifetime(t, info.nbytes, info.klass, producer[t], u, free)
    return out
