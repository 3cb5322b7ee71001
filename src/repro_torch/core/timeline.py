"""Dual-stream execution-timeline simulator.

Models the device as one compute stream plus two DMA channels (d2r / r2d,
duplex pool link). Nodes are *issued* in program order; each starts at
max(its stream's free time, completion of its dependencies) — i.e. transfers
issued early run asynchronously under compute, which is exactly the overlap
the paper's Figure 3(c) idealizes.

Also provides the *reactive runtime* baseline of §3.1: no cache operators —
instead a capacity-limited device where memory pressure triggers synchronous
LRU eviction and reads of evicted tensors stall compute for a synchronous
reload, each paying a CPU runtime-intervention cost.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import HardwareSpec
from repro_torch.core.ir import Graph


@dataclass
class Timeline:
    total: float
    compute_busy: float
    exposed_comm: float              # compute-stream idle time
    dma_busy_d2r: float
    dma_busy_r2d: float
    schedule: Dict[str, Tuple[float, float, str]]  # name -> (start, end, stream)
    stalls: int = 0                  # reactive baseline: synchronous events
    defrag_time: float = 0.0


def _node_stream(kind: str) -> str:
    if kind == "store":
        return "d2r"
    if kind == "prefetch":
        return "r2d"
    if kind == "detach":
        return "meta"   # zero-cost bookkeeping: must not stall compute
    return "compute"


def _duration(node, hw: HardwareSpec, graph: Graph) -> float:
    if node.kind == "compute":
        return hw.compute_time(node.flops, node.hbm_bytes)
    if node.kind == "store":
        return hw.transfer_time(graph.tensors[node.tensor].nbytes, "d2r")
    if node.kind == "prefetch":
        return hw.transfer_time(graph.tensors[node.tensor].nbytes, "r2d")
    return 0.0  # detach


def simulate(graph: Graph, hw: HardwareSpec,
             order: Optional[Sequence[str]] = None) -> Timeline:
    order = list(order) if order is not None else graph.order()
    deps = graph.dependencies(order)
    free = {"compute": 0.0, "d2r": 0.0, "r2d": 0.0, "meta": 0.0}
    end: Dict[str, float] = {}
    sched: Dict[str, Tuple[float, float, str]] = {}
    busy = {"compute": 0.0, "d2r": 0.0, "r2d": 0.0, "meta": 0.0}

    for name in order:
        node = graph.nodes[name]
        stream = _node_stream(node.kind)
        ready = max((end.get(d, 0.0) for d in deps[name]), default=0.0)
        start = max(ready, free[stream])
        dur = _duration(node, hw, graph)
        t_end = start + dur
        free[stream] = t_end
        busy[stream] += dur
        end[name] = t_end
        sched[name] = (start, t_end, stream)

    total = max(end.values(), default=0.0)
    return Timeline(
        total=total,
        compute_busy=busy["compute"],
        exposed_comm=max(0.0, total - busy["compute"]),
        dma_busy_d2r=busy["d2r"],
        dma_busy_r2d=busy["r2d"],
        schedule=sched,
    )


# ---------------------------------------------------------------------------
# Reactive runtime baseline (§3.1)
# ---------------------------------------------------------------------------


def simulate_reactive(graph: Graph, hw: HardwareSpec,
                      capacity: float,
                      order: Optional[Sequence[str]] = None) -> Timeline:
    """Runtime-driven swapping: evict LRU on pressure, reload on demand.
    All transfers are synchronous on the compute stream (the runtime cannot
    see the future, so nothing is prefetched) and each event pays
    ``hw.runtime_intervention``. Cache ops in the graph are ignored."""
    order = [n for n in (order or graph.order())
             if graph.nodes[n].kind == "compute"]
    pos = {n: i for i, n in enumerate(order)}
    last_read: Dict[str, int] = {}
    for name in order:
        for t in graph.nodes[name].inputs:
            last_read[t] = pos[name]

    resident: Dict[str, int] = {}
    lru: Dict[str, int] = {}
    evicted: set = set()
    t_now = 0.0
    compute_busy = 0.0
    stalls = 0

    def nbytes(t: str) -> int:
        return graph.tensors[t].nbytes

    produced = {t for n in graph.nodes.values() for t in n.writes()
                if n.kind == "compute"}
    for t, info in graph.tensors.items():
        if info.initial_location == "device" and t not in produced:
            resident[t] = nbytes(t)
            lru[t] = -1

    def make_room(needed: int, step: int) -> None:
        nonlocal t_now, stalls
        while sum(resident.values()) + needed > capacity and resident:
            victim = min(lru, key=lru.get)
            t_now += hw.runtime_intervention + hw.transfer_time(resident[victim], "d2r")
            stalls += 1
            evicted.add(victim)
            resident.pop(victim)
            lru.pop(victim)

    for i, name in enumerate(order):
        node = graph.nodes[name]
        # demand-load evicted inputs (synchronous: exposed latency)
        for t in node.inputs:
            if t not in resident:
                make_room(nbytes(t), i)
                t_now += hw.runtime_intervention + hw.transfer_time(nbytes(t), "r2d")
                stalls += 1
                resident[t] = nbytes(t)
            lru[t] = i
        out_bytes = sum(nbytes(t) for t in node.outputs if t not in resident)
        make_room(out_bytes, i)
        for t in node.outputs:
            resident.setdefault(t, nbytes(t))
            lru[t] = i
        dur = hw.compute_time(node.flops, node.hbm_bytes)
        t_now += dur
        compute_busy += dur
        # free dead activations
        for t in list(resident):
            info = graph.tensors[t]
            if info.klass == "activation" and last_read.get(t, -1) <= i and t not in node.outputs:
                if last_read.get(t, -1) == i:
                    resident.pop(t)
                    lru.pop(t, None)

    return Timeline(
        total=t_now,
        compute_busy=compute_busy,
        exposed_comm=max(0.0, t_now - compute_busy),
        dma_busy_d2r=0.0,
        dma_busy_r2d=0.0,
        schedule={},
        stalls=stalls,
    )
