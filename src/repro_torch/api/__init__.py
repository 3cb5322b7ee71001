"""`repro_torch.api` — the public front door of the port (the counterpart
of ``repro.api``).

One declarative `OffloadConfig` (tier topology, hardware, planner options,
transfer-depth policy, KV codec, telemetry, mode) and one
`HyperOffloadSession` that owns the pool / transfer engine / planner and
constructs every subsystem wired to them. Dump the default config with
``python -m repro_torch.api --print-config``.
"""

from repro_torch.api.config import HW_SPECS, KVCodecConfig, MODES, OffloadConfig
from repro_torch.api.session import HyperOffloadSession

__all__ = [
    "KVCodecConfig",
    "OffloadConfig",
    "HyperOffloadSession",
    "HW_SPECS",
    "MODES",
]
