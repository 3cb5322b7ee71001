"""SLO-aware scheduling policy layer of the port (the port's copy of
``repro.slo``).

- ``policy``    — ``SLOSpec`` (priority class + TTFT/TPOT deadlines,
  attached per request), ``SLOConfig``, admission ordering
  (``candidate_key``) and attainment scoring (``slo_outcome`` /
  ``attainment_summary``);
- ``admission`` — ``GoodputController``: measured-prefill-rate feasibility
  (early shedding of certainly-missed requests), deadline-pressure prefill
  budget boost, goodput accounting;
- ``preempt``   — ``PreemptionEngine``: when a deadline-pressed arrival is
  worth parking a running lower-priority sequence through the pool's
  park/restore path.

Pure policy over duck-typed request states: nothing here imports
``repro_torch.sched`` (the scheduler imports this package).
"""

from repro_torch.slo.admission import SLACK_BUCKETS, GoodputController
from repro_torch.slo.policy import (
    DEFAULT_SLO, PRIORITY_CLASSES, SLOConfig, SLOSpec, attainment_summary,
    candidate_key, slo_of, slo_outcome,
)
from repro_torch.slo.preempt import PreemptionEngine

__all__ = [
    "PRIORITY_CLASSES", "SLOSpec", "DEFAULT_SLO", "SLOConfig",
    "slo_of", "candidate_key", "slo_outcome", "attainment_summary",
    "GoodputController", "SLACK_BUCKETS",
    "PreemptionEngine",
]
