"""`OffloadConfig` — the one declarative description of an offload setup
(the counterpart of ``repro.api.config``).

One frozen, serializable object owns:

- **mode** — what the session is serving: ``resident`` (KV stays on
  device), ``kv_offload`` (whole-cache / per-page pool round trips),
  ``paged`` (page-granular `PagedKVCache` with sparse selection),
  ``continuous`` (continuous-batching scheduler, resident pages);
- **tier topology** — either the per-tier byte capacities of the default
  device/host/remote chain (``None`` = unbounded), or a full declarative
  ``TierTopology``, realized as one `MemoryPoolManager`;
- **calibration knobs** — thresholds the closed loop
  (``session.recalibrate()``) applies when folding measured per-tier-pair
  bandwidth back into the planner;
- **hardware** — a `HardwareSpec` by registry name (serializable) or
  instance, driving the planner's cost model; ``h100_sxm`` by default;
- **planner knobs** — `InsertionOptions` / `ScheduleOptions`; ``None``
  insertion means the mode's default (`PAGED_INSERTION` for the offload
  modes);
- **transfer depth policy** — ``"auto"`` derives depth from the consumer's
  shape via `pool.auto_depth` (f(pages, layers)); an int pins it;
- **training memory policy** — remat mode and the optimizer-state offload
  toggle, kept as declarative fields (the port's training slice reads
  them).

``cache_dtype`` is the reference's dtype name (``"float32"``,
``"bfloat16"``); ``OffloadConfig.dtype`` gives the ``torch.dtype``. ``to_dict``/``from_dict``
round-trip through plain JSON types (``python -m repro_torch.api
--print-config``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core.costmodel import ASCEND_LIKE, H100, TPU_V5E, HardwareSpec
from repro_torch.core.insertion import PAGED_INSERTION, InsertionOptions
from repro_torch.core.schedule import ScheduleOptions
from repro_torch.pool.codec import CODECS
from repro_torch.pool.topology import TierTopology
from repro_torch.pool.transfer import auto_depth
from repro_torch.slo.policy import SLOConfig

MODES = ("resident", "kv_offload", "paged", "continuous")
REMAT_MODES = ("none", "full", "offload")

#: Hardware specs addressable by name in a serialized config.
HW_SPECS: Dict[str, HardwareSpec] = {
    TPU_V5E.name: TPU_V5E,
    ASCEND_LIKE.name: ASCEND_LIKE,
    H100.name: H100,
}

#: cache dtypes by the reference's names
CACHE_DTYPES: Dict[str, torch.dtype] = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

#: modes whose KV tensors live in the pool (mandatory prefetches)
_OFFLOAD_MODES = ("kv_offload", "paged", "continuous")


@dataclass(frozen=True)
class PrefixCacheConfig:
    """Cross-request prefix cache knobs (``repro_torch.prefix``): disabled by
    default; enabling requires chunked prefill (``chunk_size``) on a
    scheduler mode, since a prefix hit resumes prefill at the match
    offset."""

    enable: bool = False
    page_size: int = 16            # tokens per cached/shared KV page
    max_pages: Optional[int] = None   # cache footprint budget (None = ∞)
    min_match_pages: int = 1       # shortest match worth taking
    # tier pinning policy: the lowest pool tier a cached page may age down
    # to; a page the pool spills below this floor is invalidated (cheaper
    # to recompute than to fetch back). Validated against the session's
    # tier topology by OffloadConfig (the chain's names are declarative,
    # not fixed, so this block alone can't know them).
    pin_tier: str = "host"

    def __post_init__(self) -> None:
        if self.page_size < 1:
            raise ValueError("prefix_cache.page_size must be >= 1")
        if self.max_pages is not None and self.max_pages < 1:
            raise ValueError(
                "prefix_cache.max_pages must be >= 1 (or None = unbounded)")
        if self.min_match_pages < 1:
            raise ValueError("prefix_cache.min_match_pages must be >= 1")
        if not self.pin_tier or not isinstance(self.pin_tier, str):
            raise ValueError("prefix_cache.pin_tier must be a tier name")


@dataclass(frozen=True)
class KVCodecConfig:
    """Quantized KV page codec (``repro_torch.pool.codec``): off by default
    (``codec="none"`` — pages move full precision, bit-identical serving).
    Enabling wraps every pool tier from ``below_tier`` down to the bottom
    of the chain in a ``CodecBackend``: pages quantize once on arrival
    below the boundary (per-page absmax scale stored alongside), every
    transfer across those links moves the 2–4× smaller payload, and
    admission counts the wrapped tiers at decoded-equivalent capacity.
    ``below_tier`` is validated against the session's tier topology by
    ``OffloadConfig`` (the chain's names are declarative, so this block
    alone can't know them)."""

    codec: str = "none"            # "none" | "int8" | "fp8"
    below_tier: str = "host"       # first (topmost) codec-wrapped tier

    def __post_init__(self) -> None:
        if self.codec not in CODECS:
            raise ValueError(
                f"kv_codec.codec {self.codec!r} not in {CODECS}")
        if not self.below_tier or not isinstance(self.below_tier, str):
            raise ValueError("kv_codec.below_tier must be a tier name")

    @property
    def enabled(self) -> bool:
        return self.codec != "none"


@dataclass(frozen=True)
class CalibrationConfig:
    """Closed-loop calibration knobs (``core.calibration``), applied by
    ``HyperOffloadSession.recalibrate()``: eligibility thresholds before a
    measured tier pair is trusted over the static spec (one tiny probe
    transfer is all fixed overhead — it would poison the bandwidth
    estimate), and the ceiling on how much in-flight transfer parallelism
    the loop may grow the engine to (the bandwidth-delay-product sizing is
    measured, but worker threads are a real resource)."""

    min_transfers: int = 2         # per-pair transfers before trusting it
    min_bytes: int = 1024          # per-pair bytes before trusting it
    max_inflight: int = 64         # ceiling for measured in-flight sizing

    def __post_init__(self) -> None:
        if self.min_transfers < 1:
            raise ValueError("calibration.min_transfers must be >= 1")
        if self.min_bytes < 0:
            raise ValueError("calibration.min_bytes must be >= 0")
        if self.max_inflight < 1:
            raise ValueError("calibration.max_inflight must be >= 1")


@dataclass(frozen=True)
class TelemetryConfig:
    """Unified telemetry knobs (``repro_torch.obs``): disabled by default —
    the session then uses the shared no-op ``NULL_TRACER`` and serving
    behavior/output is unchanged. Enabling gives the session ONE
    structured `Tracer` (bounded ring of ``ring_capacity`` events) and
    per-request latency histograms, shared by every subsystem it hands
    out; ``trace_path`` (optional) writes the Chrome trace-event /
    Perfetto JSON file on ``session.close()``."""

    enable: bool = False
    ring_capacity: int = 65536     # bounded event ring (oldest drop first)
    trace_path: Optional[str] = None   # export on session close

    def __post_init__(self) -> None:
        if self.ring_capacity < 1:
            raise ValueError("telemetry.ring_capacity must be >= 1")


def _options_from(cls, d: Dict[str, Any]):
    """Rebuild a frozen options dataclass from a dict, restoring the tuple
    fields JSON flattened into lists. Unknown keys are a hard error — a
    typo in a launch file must not silently fall back to a default."""
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items()})


@dataclass(frozen=True)
class OffloadConfig:
    """Frozen, serializable front-door configuration (see module doc)."""

    mode: str = "resident"

    # -- hardware + tier topology ---------------------------------------
    hw: Union[str, HardwareSpec] = H100.name
    # either a full declarative chain...
    topology: Optional[TierTopology] = None
    # ...or the legacy per-tier capacities of the default chain (bytes;
    # None = unbounded). Mutually exclusive with an explicit topology.
    device_capacity: Optional[int] = None
    host_capacity: Optional[int] = None
    remote_capacity: Optional[int] = None
    # closed-loop calibration knobs (session.recalibrate())
    calibration: CalibrationConfig = field(default_factory=CalibrationConfig)

    # -- transfer depth policy ------------------------------------------
    transfer_depth: Union[str, int] = "auto"   # "auto" = f(pages, layers)
    transfer_workers: int = 2

    # -- serving geometry -----------------------------------------------
    max_seq: int = 128
    max_batch: int = 4
    prefill_budget: int = 1
    # chunked prefill (continuous/kv_offload scheduling): chunk_size sets
    # the tokens prefilled per scheduler step through one fixed compiled
    # shape; prefill_tokens is the per-step prefill *token* budget across
    # requests (None → one chunk). None chunk_size = whole-prompt prefill.
    chunk_size: Optional[int] = None
    prefill_tokens: Optional[int] = None
    page_size: int = 32
    cache_dtype: str = "float32"
    # cross-request prefix cache (scheduler modes with chunked prefill)
    prefix_cache: PrefixCacheConfig = field(default_factory=PrefixCacheConfig)
    # quantized KV page codec below a tier boundary (repro_torch.pool.codec)
    kv_codec: KVCodecConfig = field(default_factory=KVCodecConfig)
    # unified telemetry (repro_torch.obs): tracing + metrics, off by default
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    # SLO-aware scheduling (repro_torch.slo): priority classes, deadline-driven
    # preemption, goodput-maximizing admission; off by default (pure FIFO)
    slo: SLOConfig = field(default_factory=SLOConfig)

    # -- planner knobs --------------------------------------------------
    insertion: Optional[InsertionOptions] = None   # None → mode default
    schedule: ScheduleOptions = field(default_factory=ScheduleOptions)
    refine: bool = True

    # -- training memory policy (declarative; the training slice reads it)
    remat: str = "none"
    offload_opt_state: bool = False
    host_memory_kind: Optional[str] = None   # None = probe the platform

    def __post_init__(self) -> None:
        if self.cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype {self.cache_dtype!r} not in "
                             f"{sorted(CACHE_DTYPES)}")
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat {self.remat!r} not in {REMAT_MODES}")
        if isinstance(self.hw, str) and self.hw not in HW_SPECS:
            raise ValueError(
                f"unknown hardware {self.hw!r}; have {sorted(HW_SPECS)} "
                "(or pass a HardwareSpec instance)")
        if not (self.transfer_depth == "auto"
                or (isinstance(self.transfer_depth, int)
                    and self.transfer_depth >= 1)):
            raise ValueError(
                f"transfer_depth must be 'auto' or an int >= 1, "
                f"got {self.transfer_depth!r}")
        if self.chunk_size is not None and not (
                1 <= self.chunk_size <= self.max_seq):
            raise ValueError(
                f"chunk_size {self.chunk_size} must be in [1, max_seq="
                f"{self.max_seq}]")
        if self.prefill_tokens is not None:
            if self.chunk_size is None:
                raise ValueError(
                    "prefill_tokens (a per-step prefill token budget) "
                    "requires chunk_size")
            if self.prefill_tokens < 1:
                raise ValueError("prefill_tokens must be >= 1")
        if self.prefix_cache.enable:
            if self.chunk_size is None:
                raise ValueError(
                    "prefix_cache.enable requires chunk_size (a prefix hit "
                    "resumes prefill at the match offset, which only the "
                    "chunked path supports)")
            if self.mode not in ("continuous", "kv_offload"):
                raise ValueError(
                    "prefix_cache.enable requires a scheduler mode "
                    "('continuous' or 'kv_offload'), "
                    f"got mode={self.mode!r}")
        if self.slo.enable and self.mode not in ("continuous", "kv_offload"):
            raise ValueError(
                "slo.enable requires a scheduler mode ('continuous' or "
                f"'kv_offload'), got mode={self.mode!r}")
        if self.topology is not None:
            if not isinstance(self.topology, TierTopology):
                raise ValueError(
                    "topology must be a TierTopology (build one with "
                    "TierTopology(tiers=(TierSpec(...), ...)))")
            if any(c is not None for c in (self.device_capacity,
                                           self.host_capacity,
                                           self.remote_capacity)):
                raise ValueError(
                    "pass tier capacities inside the topology's TierSpecs, "
                    "not alongside an explicit topology")
        # only an *enabled* prefix cache must name a real tier — the
        # default pin ("host") shouldn't invalidate every custom chain
        if self.prefix_cache.enable:
            names = self.tier_topology.names
            if self.prefix_cache.pin_tier not in names:
                raise ValueError(
                    f"prefix_cache.pin_tier {self.prefix_cache.pin_tier!r} "
                    f"not a tier of the topology {names}")
        # same deal for the codec boundary: only an enabled codec must
        # name a real, off-accelerator tier of the effective chain
        if self.kv_codec.enabled:
            topo = self.tier_topology
            if self.kv_codec.below_tier not in topo.names:
                raise ValueError(
                    f"kv_codec.below_tier {self.kv_codec.below_tier!r} "
                    f"not a tier of the topology {topo.names}")
            spec = next(t for t in topo.tiers
                        if t.name == self.kv_codec.below_tier)
            if spec.kind == "device":
                raise ValueError(
                    f"kv_codec.below_tier {self.kv_codec.below_tier!r} is "
                    "an accelerator tier; the compute path needs "
                    "full-precision pages on device — pick an "
                    "off-accelerator tier")

    # ------------------------------------------------------------------
    @property
    def hardware(self) -> HardwareSpec:
        return HW_SPECS[self.hw] if isinstance(self.hw, str) else self.hw

    @property
    def tier_topology(self) -> TierTopology:
        """The effective chain: the explicit topology, else the default
        device/host/remote chain under the legacy capacity fields."""
        if self.topology is not None:
            return self.topology
        return TierTopology.default(device_capacity=self.device_capacity,
                                    host_capacity=self.host_capacity,
                                    remote_capacity=self.remote_capacity)

    @property
    def offload_kv(self) -> bool:
        """Does this mode park KV state in the pool between steps?"""
        return self.mode == "kv_offload"

    @property
    def dtype(self) -> torch.dtype:
        return CACHE_DTYPES[self.cache_dtype]

    def insertion_options(self) -> InsertionOptions:
        """Explicit options, else the mode default: offload modes plan every
        pool-resident KV tensor (`PAGED_INSERTION`, the documented old
        ``min_bytes=1``); resident keeps the cost-model thresholds."""
        if self.insertion is not None:
            return self.insertion
        return PAGED_INSERTION if self.mode in _OFFLOAD_MODES \
            else InsertionOptions()

    def depth_for(self, *, layers: Optional[int] = None,
                  pages: Optional[int] = None) -> int:
        """Resolve the transfer depth for a consumer of the given shape."""
        if self.transfer_depth == "auto":
            return auto_depth(layers=layers, pages=pages)
        return int(self.transfer_depth)

    # -- serialization --------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON-types dict; ``from_dict`` inverts it exactly."""
        d = dataclasses.asdict(self)
        hw = self.hw
        if isinstance(hw, HardwareSpec):
            # a registered spec serializes by name; a custom one by fields
            if HW_SPECS.get(hw.name) == hw:
                d["hw"] = hw.name
            else:
                d["hw"] = dataclasses.asdict(hw)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OffloadConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown OffloadConfig fields: {sorted(unknown)}")
        kwargs = dict(d)
        hw = kwargs.get("hw")
        if isinstance(hw, dict):
            kwargs["hw"] = HardwareSpec(**hw)
        if isinstance(kwargs.get("topology"), dict):
            kwargs["topology"] = TierTopology.from_dict(kwargs["topology"])
        if isinstance(kwargs.get("calibration"), dict):
            kwargs["calibration"] = _options_from(CalibrationConfig,
                                                  kwargs["calibration"])
        if isinstance(kwargs.get("insertion"), dict):
            kwargs["insertion"] = _options_from(InsertionOptions,
                                                kwargs["insertion"])
        if isinstance(kwargs.get("schedule"), dict):
            kwargs["schedule"] = _options_from(ScheduleOptions,
                                               kwargs["schedule"])
        if isinstance(kwargs.get("prefix_cache"), dict):
            kwargs["prefix_cache"] = _options_from(PrefixCacheConfig,
                                                   kwargs["prefix_cache"])
        if isinstance(kwargs.get("kv_codec"), dict):
            kwargs["kv_codec"] = _options_from(KVCodecConfig,
                                               kwargs["kv_codec"])
        if isinstance(kwargs.get("telemetry"), dict):
            kwargs["telemetry"] = _options_from(TelemetryConfig,
                                                kwargs["telemetry"])
        if isinstance(kwargs.get("slo"), dict):
            kwargs["slo"] = _options_from(SLOConfig, kwargs["slo"])
        return cls(**kwargs)

    def replace(self, **changes) -> "OffloadConfig":
        return dataclasses.replace(self, **changes)
