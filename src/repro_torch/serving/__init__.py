"""Batched serving over the port's model decode path (resident and
``offload_kv``)."""

from repro_torch.serving.engine import ServeEngine, ServeStats
from repro_torch.serving.sampling import sample_token

__all__ = ["ServeEngine", "ServeStats", "sample_token"]
