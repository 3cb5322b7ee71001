"""Compile-time cache-operator insertion (§4.2.2).

Given a plain compute graph, decide which tensors are worth parking in the
remote pool and materialize the decision as Store/Detach/Prefetch nodes:

- *activations* with a long idle gap (produced in forward, consumed in
  backward): offload if the gap's estimated compute time covers the
  round-trip transfer and the tensor is large enough to matter. Short-lived
  or fine-grained tensors are rejected by the same test — the paper's §5.1
  "not good candidates" rule falls out of the cost model.
- *weights/states* declared remote-initial (optimizer states, offloaded KV
  blocks, cold expert weights): a Prefetch lands before the first consumer;
  if a consumer *writes* a successor state tensor, the successor gets
  Store+Detach after its producer.

The ops are inserted at conservative (late-prefetch) positions; Algorithm 1
(schedule.refine_order) then slides them to just-in-time positions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import lifetime as lt
from repro_torch.core.costmodel import HardwareSpec
from repro_torch.core.ir import Graph, Node


@dataclass(frozen=True)
class InsertionOptions:
    min_bytes: int = 1 << 20          # ignore tensors below 1 MiB
    safety: float = 1.25              # required idle-time / transfer-time ratio
    offload_activations: bool = True
    offload_states: bool = True
    # aggregate DMA budget: total offload traffic per direction may use at
    # most this fraction of the step's compute time — offloading more than
    # the link can hide only converts memory pressure into exposed latency
    bandwidth_budget: float = 0.9
    # tensors whose name starts with one of these prefixes (or appears in
    # force_tensors) are offloaded unconditionally (capacity-driven, e.g. KV
    # caches in the paper's Table 3 — the decode slowdown is accepted for
    # the memory win)
    force_prefixes: Tuple[str, ...] = ()
    force_tensors: Tuple[str, ...] = ()


#: The paged-serving default (``OffloadConfig`` modes ``paged`` /
#: ``kv_offload`` / ``continuous``): pool-resident KV tensors *must* be
#: planned — their prefetch is mandatory, not a cost-model choice — so the
#: size filter is disabled. Was hard-coded at the PlanPrefetcher call site
#: before the ``repro_torch.api`` front door existed.
PAGED_INSERTION = InsertionOptions(min_bytes=1)


def _node_durations(graph: Graph, hw: HardwareSpec,
                    order: Sequence[str]) -> Dict[str, float]:
    return {
        n: hw.compute_time(graph.nodes[n].flops, graph.nodes[n].hbm_bytes)
        if graph.nodes[n].kind == "compute" else 0.0
        for n in order
    }


def _rebuild(graph: Graph, order: Sequence[str]) -> Graph:
    g = Graph()
    g.tensors = dict(graph.tensors)
    for name in order:
        g.nodes[name] = graph.nodes[name]
    return g


def insert_cache_ops(graph: Graph, hw: HardwareSpec,
                     opts: InsertionOptions = InsertionOptions()) -> Graph:
    """Returns a new Graph containing cache operators. Node objects are
    shared; ordering is the original order with cache ops spliced in."""
    order = graph.order()
    lifetimes = lt.analyze(graph, order)
    durations = _node_durations(graph, hw, order)
    # prefix[i] = total compute time of nodes [0, i)
    prefix: List[float] = [0.0]
    for n in order:
        prefix.append(prefix[-1] + durations[n])

    def window_time(a: int, b: int) -> float:
        """Compute time strictly between positions a and b."""
        return prefix[b] - prefix[a + 1]

    inserts: List[Tuple[int, Node]] = []   # (position before which to insert, node)
    # opportunistic candidates competing for the DMA budget:
    # (priority, d2r_cost, r2d_cost, [(pos, Node), ...])
    candidates: List[Tuple[float, float, float, List[Tuple[int, Node]]]] = []

    force_set = frozenset(opts.force_tensors)

    def forced(t: str) -> bool:
        return t in force_set or any(t.startswith(p) for p in opts.force_prefixes)

    for t, life in lifetimes.items():
        info = graph.tensors[t]
        if info.nbytes < opts.min_bytes:
            continue
        d2r = hw.transfer_time(info.nbytes, "d2r")
        r2d = hw.transfer_time(info.nbytes, "r2d")

        if info.klass == "activation" and (opts.offload_activations or forced(t)):
            if life.producer_pos is None or not life.use_positions:
                continue
            g0, g1 = life.longest_gap()
            if g1 - g0 <= 1:
                continue
            idle = window_time(g0, g1)
            if idle < (d2r + r2d) * opts.safety and not forced(t):
                continue  # transfer can't amortize — keep resident (§5.1)
            ops = [(g0 + 1, Node(f"store::{t}", "store", tensor=t)),
                   (g0 + 1, Node(f"detach::{t}", "detach", tensor=t)),
                   (g1, Node(f"prefetch::{t}", "prefetch", tensor=t))]
            if forced(t):
                inserts.extend(ops)
            else:
                # priority: memory-seconds saved per second of link time
                saved = info.nbytes * idle
                candidates.append((saved / max(d2r + r2d, 1e-12), d2r, r2d, ops))

        elif info.klass in ("weight", "state") and (opts.offload_states or forced(t)):
            if info.initial_location == "remote":
                # the tensor LIVES in the pool — its prefetch is mandatory
                # (correctness), never subject to the bandwidth budget
                if not life.use_positions:
                    continue
                first = life.first_use
                inserts.append((first, Node(f"prefetch::{t}", "prefetch", tensor=t)))
                # park it again after its last use if the tail can absorb it
                last = life.last_use
                tail = prefix[-1] - prefix[last + 1]
                if tail >= d2r:
                    inserts.append((last + 1, Node(f"detach::{t}", "detach", tensor=t)))
            elif (info.klass == "state" and life.producer_pos is not None
                  and (life.last_use is None or life.last_use < life.producer_pos)):
                # state produced in-step and not read again (e.g. updated
                # optimizer moments, freshly appended KV blocks): stream it
                # back to the pool right after its producer
                p = life.producer_pos
                ops = [(p + 1, Node(f"store::{t}", "store", tensor=t)),
                       (p + 1, Node(f"detach::{t}", "detach", tensor=t))]
                if forced(t):
                    inserts.extend(ops)
                else:
                    tail = prefix[-1] - prefix[p + 1]
                    candidates.append((info.nbytes * max(tail, 1e-9) / max(d2r, 1e-12),
                                       d2r, 0.0, ops))

    # greedy selection under the per-direction DMA budget
    budget = opts.bandwidth_budget * prefix[-1]
    used_d2r = used_r2d = 0.0
    for prio, c_d2r, c_r2d, ops in sorted(candidates, key=lambda c: -c[0]):
        if used_d2r + c_d2r > budget or used_r2d + c_r2d > budget:
            continue
        used_d2r += c_d2r
        used_r2d += c_r2d
        inserts.extend(ops)

    # splice: stable sort by target position; store before detach before
    # prefetch at equal positions (store must precede its detach)
    kind_rank = {"store": 0, "detach": 1, "prefetch": 2}
    inserts.sort(key=lambda x: (x[0], kind_rank[x[1].kind]))
    new_order: List[str] = []
    nodes: Dict[str, Node] = {}
    it = iter(inserts)
    pending = next(it, None)
    for i, name in enumerate(order):
        while pending is not None and pending[0] <= i:
            nodes[pending[1].name] = pending[1]
            new_order.append(pending[1].name)
            pending = next(it, None)
        nodes[name] = graph.nodes[name]
        new_order.append(name)
    while pending is not None:
        nodes[pending[1].name] = pending[1]
        new_order.append(pending[1].name)
        pending = next(it, None)

    # remote-initial tensors whose prefetch was NOT selected (over budget)
    # simply stay device-resident — flip their initial location
    prefetched = {n.tensor for _, n in inserts if n.kind == "prefetch"}
    tensors = {}
    for t, info in graph.tensors.items():
        if info.initial_location == "remote" and t not in prefetched:
            import dataclasses as _dc
            info = _dc.replace(info, initial_location="device")
        tensors[t] = info

    g = Graph()
    g.tensors = tensors
    g.nodes = {n: nodes[n] for n in new_order}
    g.validate_order(g.order())
    return g
