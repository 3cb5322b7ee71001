"""Device-memory ledger: peak usage of an execution order.

Walks the order maintaining the set of device-resident tensors under the IR
memory semantics (ir.py docstring). This is the compiler's deterministic
memory plan — the quantity HyperOffload minimizes subject to not stalling
compute (§3.3's residency/overlap trade-off).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.ir import Graph


@dataclass
class MemoryTrace:
    peak_bytes: int
    peak_pos: int
    usage: List[int]                      # resident bytes after each node
    resident_at_peak: Tuple[str, ...] = ()
    # event trace for the allocator simulator: (pos, "alloc"/"free", tensor)
    events: List[Tuple[int, str, str]] = field(default_factory=list)


def simulate(graph: Graph, order: Optional[Sequence[str]] = None) -> MemoryTrace:
    order = list(order) if order is not None else graph.order()
    graph.validate_order(order)
    pos = {n: i for i, n in enumerate(order)}

    # last read of each tensor (by compute or store) under this order
    last_read: Dict[str, int] = {}
    for name in order:
        node = graph.nodes[name]
        for t in node.reads():
            last_read[t] = pos[name]

    produced = {t for n in graph.nodes.values() for t in n.writes()
                if n.kind == "compute"}
    resident: Dict[str, int] = {}
    events: List[Tuple[int, str, str]] = []
    for t, info in graph.tensors.items():
        # initially resident: device-located graph INPUTS (weights/states);
        # tensors produced by compute nodes materialize at their producer
        if info.initial_location == "device" and t not in produced:
            resident[t] = info.nbytes
            events.append((-1, "alloc", t))

    usage: List[int] = []
    cur = sum(resident.values())
    peak, peak_pos, peak_set = cur, -1, tuple(resident)

    def free(t: str, p: int) -> None:
        nonlocal cur
        if t in resident:
            cur -= resident.pop(t)
            events.append((p, "free", t))

    def alloc(t: str, p: int) -> None:
        nonlocal cur
        if t not in resident:
            resident[t] = graph.tensors[t].nbytes
            cur += resident[t]
            events.append((p, "alloc", t))

    for i, name in enumerate(order):
        node = graph.nodes[name]
        if node.kind == "compute":
            for t in node.outputs:
                alloc(t, i)
        elif node.kind == "prefetch":
            alloc(node.tensor, i)
        elif node.kind == "detach":
            free(node.tensor, i)
        # release dead ordinary tensors (activations past their last read)
        for t in node.reads():
            info = graph.tensors[t]
            if info.klass == "activation" and last_read.get(t, -1) == i:
                free(t, i)
        if cur > peak:
            peak, peak_pos, peak_set = cur, i, tuple(resident)
        usage.append(cur)

    return MemoryTrace(peak_bytes=peak, peak_pos=peak_pos, usage=usage,
                       resident_at_peak=peak_set, events=events)


def peak_bytes(graph: Graph, order: Optional[Sequence[str]] = None) -> int:
    return simulate(graph, order).peak_bytes
