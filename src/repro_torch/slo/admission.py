"""Goodput-maximizing admission control.

``GoodputController`` is the scheduler's SLO brain for *which queued work
is worth admitting*: it tracks the measured per-step prefill rate (the
same signal the obs registry's prefill counters expose, kept here as a
cheap EWMA so the feasibility estimate adapts to the boost level actually
achieved), declares requests whose TTFT deadline is already unmeetable
**infeasible** so the scheduler sheds them before they waste prefill
(admitted-then-missed work is the overload failure mode FIFO exhibits),
and raises the chunked-prefill token budget under deadline pressure —
bounded by ``SLOConfig.max_prefill_boost`` so deadline-pressed prompts
cannot starve running decodes without limit.

Retirement accounting flows through ``note_retired``: deadline-met tokens
accumulate into ``goodput_tokens`` (the benchmark's goodput numerator) and
each TTFT-deadline request observes its deadline-relative slack into the
``req_ttft_slack_steps`` histogram (negative buckets = missed-by).

No imports from ``repro_torch.sched`` — states are duck-typed.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.slo.policy import SLOConfig, slo_of, slo_outcome

#: deadline-relative TTFT slack histogram buckets (steps; negative =
#: missed by that much)
SLACK_BUCKETS = (-64, -16, -4, -1, 0, 1, 4, 16, 64)

_EWMA_ALPHA = 0.2


class GoodputController:
    def __init__(self, cfg: SLOConfig,
                 metrics: Optional[MetricsRegistry] = None) -> None:
        self.cfg = cfg
        # raw counters (session collectors merge these across schedulers)
        self.goodput_tokens = 0
        self.met_requests = 0
        self.missed_requests = 0
        self.boosted_steps = 0
        self._prefill_ewma: Optional[float] = None
        self._g_rate = self._h_slack = None
        if metrics is not None:
            self._g_rate = metrics.gauge(
                "slo_prefill_tokens_per_step",
                "EWMA of prefill tokens actually landed per scheduler step")
            self._h_slack = metrics.histogram(
                "req_ttft_slack_steps", SLACK_BUCKETS,
                "TTFT deadline minus achieved TTFT, scheduler steps "
                "(negative = deadline missed by that much)")

    # -- measured prefill rate -----------------------------------------
    def note_step(self, prefill_tokens: int) -> None:
        """Feed one step's landed prefill tokens. Idle steps (no prefill
        work) don't decay the estimate — the rate measures what a step
        *can* land, not utilization."""
        if prefill_tokens <= 0:
            return
        if self._prefill_ewma is None:
            self._prefill_ewma = float(prefill_tokens)
        else:
            self._prefill_ewma += _EWMA_ALPHA * (prefill_tokens
                                                 - self._prefill_ewma)
        if self._g_rate is not None:
            self._g_rate.set(self._prefill_ewma)

    def rate(self, base: int) -> float:
        """Prefill tokens per step for feasibility estimates: the measured
        EWMA, floored at the configured base budget (the scheduler always
        runs at least one chunk per step when prefill work exists)."""
        if self._prefill_ewma is None:
            return float(base)
        return max(float(base), self._prefill_ewma)

    # -- admission-time feasibility ------------------------------------
    def infeasible(self, state: Any, now: float,
                   est_prefill_steps: float) -> bool:
        """True when the request's TTFT deadline cannot be met even if
        admitted *right now* (optimistic estimate: no further queueing).
        Only such certainly-hopeless requests are shed."""
        if not self.cfg.shed_infeasible:
            return False
        spec = slo_of(state)
        if spec.ttft_deadline is None:
            return False
        return now + est_prefill_steps > state.request.arrival \
            + spec.ttft_deadline

    # -- deadline-pressure prefill boost -------------------------------
    def boost_budget(self, base: int, mid_states: Iterable[Any],
                     now: float) -> int:
        """Per-step prefill token budget, raised when a mid-prefill
        request's remaining prompt cannot land within its TTFT slack at
        the base rate; capped at ceil(base * max_prefill_boost)."""
        need = 0
        for s in mid_states:
            spec = slo_of(s)
            if spec.ttft_deadline is None:
                continue
            remaining = s.request.prompt_len - s.prefill_pos
            if remaining <= 0:
                continue
            slack = s.request.arrival + spec.ttft_deadline - now
            need = max(need, math.ceil(remaining / max(slack, 1.0)))
        cap = max(math.ceil(base * self.cfg.max_prefill_boost), base)
        budget = min(max(base, need), cap)
        if budget > base:
            self.boosted_steps += 1
        return budget

    # -- retirement accounting -----------------------------------------
    def note_retired(self, state: Any) -> None:
        """Accumulate one finished (DONE or SHED) state's outcome."""
        o = slo_outcome(state)
        if o["shed"]:
            return   # SchedStats.shed is the canonical shed counter
        if o["met"]:
            self.met_requests += 1
            self.goodput_tokens += o["tokens"]
        else:
            self.missed_requests += 1
        if self._h_slack is not None and o["ttft_slack"] is not None:
            self._h_slack.observe(o["ttft_slack"])

    def snapshot(self) -> Dict[str, int]:
        """Raw counters only (no ratios) — the session's sched collector
        merges these numerically across schedulers."""
        return {"goodput_tokens": self.goodput_tokens,
                "met_requests": self.met_requests,
                "missed_requests": self.missed_requests,
                "boosted_steps": self.boosted_steps}
