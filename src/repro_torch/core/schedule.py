"""Graph-Driven Execution-Order Optimization — Algorithm 1 of the paper.

Starting from a valid topological order, each *independent* cache operator
(prefetches, whose only constraints are "after the matching store / remote
copy" and "before the first consumer") is tried at a set of feasible
positions. A cost model scores each position on (a) exposed communication
latency — does the transfer complete before the consumer needs it? — and
(b) memory residency — how long does the prefetched tensor sit idle in
device memory? The placement minimizing the combined cost is kept.

This resolves the §3.3 trade-off: too late ⇒ stalls (Fig. 4a); too early ⇒
residency waste (Fig. 4b); Algorithm 1 lands just-in-time (Fig. 4c).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import memsim, timeline
from repro_torch.core.costmodel import HardwareSpec
from repro_torch.core.ir import Graph


@dataclass(frozen=True)
class ScheduleOptions:
    max_candidates: int = 24          # feasible positions sampled per cache op
    mem_weight: float = 1.0           # λ: seconds of cost per (HBM of residency)·s
    passes: int = 1


def _first_consumer_pos(graph: Graph, order: List[str], tensor: str,
                        after: int) -> Optional[int]:
    for i in range(after + 1, len(order)):
        node = graph.nodes[order[i]]
        if node.kind == "compute" and tensor in node.inputs:
            return i
    return None


def _earliest_legal_pos(graph: Graph, order: List[str], c_idx: int) -> int:
    """A prefetch may move up to just after its matching store (or to the
    front if the tensor starts remote) and after its explicit control deps."""
    node = graph.nodes[order[c_idx]]
    lo = 0
    for i in range(c_idx - 1, -1, -1):
        n = graph.nodes[order[i]]
        if n.kind in ("store", "detach") and n.tensor == node.tensor:
            lo = i + 1
            break
    pos = {name: i for i, name in enumerate(order)}
    for dep in node.after:
        lo = max(lo, pos[dep] + 1)
    return lo


def _cost(graph: Graph, order: List[str], hw: HardwareSpec, c_name: str,
          u_pos: Optional[int], opts: ScheduleOptions) -> float:
    tl = timeline.simulate(graph, hw, order)
    # latency term: exposed communication on the compute stream.
    # memory term: peak residency of this order (the device buffer is
    # reserved at DMA issue — the position-based ledger captures early-issue
    # waste that wall-clock DMA start times alone would hide).
    mem = memsim.simulate(graph, order)
    return (tl.exposed_comm
            + opts.mem_weight * (mem.peak_bytes / hw.hbm_bytes) * max(tl.total, 1e-9))


def refine_order(graph: Graph, hw: HardwareSpec,
                 order: Optional[Sequence[str]] = None,
                 opts: ScheduleOptions = ScheduleOptions()) -> List[str]:
    """Algorithm 1. Returns a refined order (a permutation of all nodes that
    still validates). The input graph is not modified."""
    order = list(order) if order is not None else graph.order()
    graph.validate_order(order)

    for _ in range(opts.passes):
        cache_ops = [n for n in order if graph.nodes[n].kind == "prefetch"]
        for c_name in cache_ops:
            c_idx = order.index(c_name)
            tensor = graph.nodes[c_name].tensor
            lo = _earliest_legal_pos(graph, order, c_idx)
            # first consumer *after* the earliest legal point (uses before the
            # offload gap — e.g. the forward pass — don't bound this prefetch)
            u_pos = _first_consumer_pos(graph, order, tensor, lo - 1)
            hi = u_pos if u_pos is not None else len(order)
            if hi <= lo:
                continue
            # candidate insertion positions in [lo, hi)
            span = hi - lo
            if span <= opts.max_candidates:
                cand = list(range(lo, hi))
            else:
                step = span / opts.max_candidates
                cand = sorted({lo + int(i * step) for i in range(opts.max_candidates)} | {hi - 1})
            cand.reverse()  # evaluate latest-first: ties resolve to minimal residency
            best_order, best_cost = None, None
            for p in cand:
                trial = order.copy()
                trial.remove(c_name)
                # removing shifts indices after c_idx left by one
                insert_at = p if p <= c_idx else p - 1
                trial.insert(insert_at, c_name)
                try:
                    graph.validate_order(trial)
                except ValueError:
                    continue
                u_now = _first_consumer_pos(graph, trial, tensor, insert_at)
                cost = _cost(graph, trial, hw, c_name, u_now, opts)
                if best_cost is None or cost < best_cost - 1e-12:
                    best_cost, best_order = cost, trial
            if best_order is not None:
                order = best_order
    graph.validate_order(order)
    return order
