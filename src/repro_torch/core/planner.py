"""End-to-end HyperOffload planning pipeline.

``HyperOffloadPlanner.plan(graph)`` = insertion (§4.2.2) → Algorithm 1
execution-order refinement (§4.3) → timeline + memory evaluation, returning
an ``OffloadPlan`` carrying both the optimized artifacts and the baselines
(resident-everything and reactive-runtime) the paper compares against.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core import allocator, insertion, memsim, schedule, timeline
from repro_torch.core.costmodel import HardwareSpec
from repro_torch.core.ir import Graph


@dataclass
class OffloadPlan:
    graph: Graph                     # graph with cache operators
    order: List[str]                 # refined execution order
    timeline: timeline.Timeline      # optimized timeline
    memory: memsim.MemoryTrace       # optimized memory trace
    base_timeline: timeline.Timeline # no offloading, everything resident
    base_memory: memsim.MemoryTrace
    naive_timeline: Optional[timeline.Timeline] = None  # unrefined cache-op order
    naive_memory: Optional[memsim.MemoryTrace] = None
    reactive_timeline: Optional[timeline.Timeline] = None

    # ------------------------------------------------------------------
    @property
    def peak_reduction(self) -> float:
        b = self.base_memory.peak_bytes
        return 0.0 if b == 0 else 1.0 - self.memory.peak_bytes / b

    @property
    def slowdown(self) -> float:
        b = self.base_timeline.total
        return 0.0 if b == 0 else self.timeline.total / b - 1.0

    def summary(self) -> Dict[str, float]:
        return {
            "base_peak_gb": self.base_memory.peak_bytes / 1e9,
            "opt_peak_gb": self.memory.peak_bytes / 1e9,
            "peak_reduction": self.peak_reduction,
            "base_step_s": self.base_timeline.total,
            "opt_step_s": self.timeline.total,
            "exposed_comm_s": self.timeline.exposed_comm,
            "slowdown": self.slowdown,
        }


class HyperOffloadPlanner:
    def __init__(self, hw: HardwareSpec,
                 insert_opts: insertion.InsertionOptions = insertion.InsertionOptions(),
                 sched_opts: schedule.ScheduleOptions = schedule.ScheduleOptions(),
                 reactive_capacity: Optional[float] = None) -> None:
        self.hw = hw
        self.insert_opts = insert_opts
        self.sched_opts = sched_opts
        self.reactive_capacity = reactive_capacity

    def with_hardware(self, hw: HardwareSpec) -> "HyperOffloadPlanner":
        """The same planning policy under a different hardware model — the
        calibration loop swaps in a ``CalibratedHardwareSpec`` this way so
        every subsequent plan's transfer estimates are measured, not
        assumed."""
        return HyperOffloadPlanner(hw, insert_opts=self.insert_opts,
                                   sched_opts=self.sched_opts,
                                   reactive_capacity=self.reactive_capacity)

    def plan(self, graph: Graph, refine: bool = True) -> OffloadPlan:
        base = graph.residentize()
        base_tl = timeline.simulate(base, self.hw)
        base_mem = memsim.simulate(base)

        g = insertion.insert_cache_ops(graph, self.hw, self.insert_opts)
        naive_order = g.order()
        naive_tl = timeline.simulate(g, self.hw, naive_order)
        naive_mem = memsim.simulate(g, naive_order)

        order = (schedule.refine_order(g, self.hw, naive_order, self.sched_opts)
                 if refine else naive_order)
        tl = timeline.simulate(g, self.hw, order)
        mem = memsim.simulate(g, order)

        reactive_tl = None
        if self.reactive_capacity is not None:
            reactive_tl = timeline.simulate_reactive(
                base, self.hw, self.reactive_capacity)

        return OffloadPlan(
            graph=g, order=order, timeline=tl, memory=mem,
            base_timeline=base_tl, base_memory=base_mem,
            naive_timeline=naive_tl, naive_memory=naive_mem,
            reactive_timeline=reactive_tl,
        )
