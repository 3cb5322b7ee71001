"""SLO policy vocabulary of the port (``policy``: ``SLOSpec``,
``SLOConfig``, ``candidate_key``, attainment scoring). The goodput
controller and the preemption engine are not ported yet, so the port's
scheduler refuses an enabled ``SLOConfig``."""

from repro_torch.slo.policy import (
    DEFAULT_SLO, PRIORITY_CLASSES, SLOConfig, SLOSpec, attainment_summary,
    candidate_key, slo_of, slo_outcome,
)

__all__ = [
    "PRIORITY_CLASSES", "SLOSpec", "DEFAULT_SLO", "SLOConfig",
    "slo_of", "candidate_key", "slo_outcome", "attainment_summary",
]
