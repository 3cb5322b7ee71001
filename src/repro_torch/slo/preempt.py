"""Deadline-driven preemption policy.

``PreemptionEngine`` decides *whether* seating a deadline-pressed arrival
is worth parking a running lower-priority sequence; the *mechanics* —
parking the victim's KV rows through the pool, freeing its slot, restoring
it when pressure drops — live in the scheduler, which already has the
page-by-page park/restore path this policy reuses as its
preemption primitive.

A victim is picked only when every cheaper option is exhausted:

- the candidate carries a TTFT deadline (pure-throughput work never
  preempts anyone);
- waiting for a natural retirement would miss the deadline (the earliest
  slot release, ``min(remaining_steps)``, is later than the candidate's
  slack);
- a running sequence of *strictly lower* priority class with more than one
  step of work left exists (never preempt within a class — FIFO fairness
  — and never park a sequence about to retire on its own);
- the per-step preemption quota (``SLOConfig.max_preempt_per_step``)
  isn't spent (thrash guard).

Among eligible victims the lowest class with the **most** remaining work
is parked: its pages will sit in the pool longest anyway, so parking it
costs the least progress per freed step.

No imports from ``repro_torch.sched`` — states are duck-typed and the
scheduler passes its remaining-work estimator in as a callback.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from repro_torch.slo.policy import SLOConfig, slo_of


class PreemptionEngine:
    def __init__(self, cfg: SLOConfig) -> None:
        self.cfg = cfg
        self._this_step = 0

    def begin_step(self) -> None:
        """Reset the per-step preemption quota."""
        self._this_step = 0

    def pick_victim(self, candidate: Any, running: Sequence[Any],
                    now: float, *, est_prefill_steps: float,
                    remaining_steps: Callable[[Any], int]) -> Optional[Any]:
        """The running state to park so ``candidate`` can take its slot,
        or None when preemption is off-policy (see module doc)."""
        if not self.cfg.preemption or not running:
            return None
        if self._this_step >= self.cfg.max_preempt_per_step:
            return None
        spec = slo_of(candidate)
        if spec.ttft_deadline is None:
            return None
        slack = (candidate.request.arrival + spec.ttft_deadline
                 - now - est_prefill_steps)
        if slack >= min(remaining_steps(s) for s in running):
            return None   # a slot frees in time — patience suffices
        victims = [s for s in running
                   if slo_of(s).rank < spec.rank and remaining_steps(s) > 1]
        if not victims:
            return None
        self._this_step += 1
        return min(victims, key=lambda s: (slo_of(s).rank,
                                           -remaining_steps(s), s.req_id))
