"""Continuous-batching serving scheduler with plan-driven KV prefetch (the
port's copy of ``repro.sched``).

- ``requests``  — ``Request``/``RequestState`` lifecycle (QUEUED → PREFILL
  → DECODE → DONE) with per-request ``KVPageTable`` page tables;
- ``queue``     — arrival queue + pool-capacity-aware admission control,
  and the seeded ``poisson_trace``;
- ``scheduler`` — the step loop: joins/retires sequences every decode step,
  interleaves (whole-prompt or chunked) prefill with decode, parks
  sequences' pages through the pool's priority+LRU manager;
- ``prefetch``  — plan-driven prefetcher running ``HyperOffloadPlanner``'s
  refined decode order at serving time: layer *l+1*'s page fetches issue
  while layer *l*'s are consumed;
- ``graph``     — the batched decode step captured once as a CUDA graph
  and replayed every step, where the step allows it (port only).
"""

from repro_torch.sched.prefetch import InFlightFetches, PlanPrefetcher, PrefetchStats
from repro_torch.sched.queue import AdmissionController, ArrivalQueue, poisson_trace
from repro_torch.sched.requests import (
    DECODE, DONE, PREEMPTED, PREFILL, QUEUED, SHED, Request, RequestState,
)
from repro_torch.sched.scheduler import (
    ContinuousScheduler, SchedStats, SchedulerConfig,
)

__all__ = [
    "QUEUED", "PREFILL", "DECODE", "DONE", "PREEMPTED", "SHED",
    "Request", "RequestState",
    "ArrivalQueue", "AdmissionController", "poisson_trace",
    "PlanPrefetcher", "PrefetchStats", "InFlightFetches",
    "ContinuousScheduler", "SchedulerConfig", "SchedStats",
]
