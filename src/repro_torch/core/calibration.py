"""Closed-loop calibration: measured transfer telemetry → planner inputs
(the port's copy of ``repro.core.calibration``).

The planner's transfer estimates come from a static ``HardwareSpec`` —
numbers typed in from datasheets. But the runtime *measures* every byte
the hierarchy actually moves: the transfer engine's per tier-pair table
(``TransferStats.pairs``) accumulates {transfers, bytes, busy_s} for each
``src->dst`` link, where busy_s is summed per-transfer execution time.
This module closes the loop the paper's global-planning argument implies:

1. ``measurements_from_pairs`` lifts the raw table into
   ``TierPairMeasurement``s;
2. ``calibrate`` folds them into a ``CalibratedHardwareSpec`` — the same
   planner interface (``transfer_time`` etc.), but with pool bandwidths
   replaced by byte-weighted *measured* bandwidth per direction, plus the
   full per-pair table for N-tier topologies;
3. ``required_inflight`` sizes prefetch parallelism to the measured
   bandwidth-delay product: on a latency-dominated tier, completing a
   step's worth of fetches inside the overlap window needs
   ``pages × mean_transfer_time / window`` transfers genuinely in flight.

``HyperOffloadSession.recalibrate()`` drives all three: replan with the
calibrated spec, grow the engine to the required parallelism.

Thin-data guards: pairs with fewer than ``min_transfers`` transfers or
``min_bytes`` total bytes are ignored (a single tiny probe transfer is
dominated by fixed overheads and would poison the bandwidth estimate);
with no eligible measurement in a direction, the static number survives.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.costmodel import HardwareSpec

#: default eligibility thresholds (mirrored by ``api.CalibrationConfig``)
MIN_TRANSFERS = 2
MIN_BYTES = 1024


@dataclass(frozen=True)
class TierPairMeasurement:
    """Aggregated measured movement over one directed tier pair."""

    src: str
    dst: str
    transfers: int
    nbytes: int
    busy_s: float

    @property
    def bandwidth(self) -> float:
        """Per-stream measured bytes/s (busy time double-counts concurrent
        transfers, so this is the single-transfer rate a planner's
        ``transfer_time`` estimate should match)."""
        return self.nbytes / self.busy_s if self.busy_s > 0 else 0.0

    @property
    def mean_transfer_s(self) -> float:
        return self.busy_s / self.transfers if self.transfers else 0.0


def measurements_from_pairs(
        pairs: Mapping[str, Mapping[str, float]],
) -> Dict[Tuple[str, str], TierPairMeasurement]:
    """Parse ``TransferStats.pairs`` (keys ``"src->dst"``) into typed
    measurements keyed by the (src, dst) tuple."""
    out: Dict[Tuple[str, str], TierPairMeasurement] = {}
    for key, b in pairs.items():
        src, sep, dst = key.partition("->")
        if not sep or not src or not dst:
            raise ValueError(f"malformed tier-pair key {key!r}")
        out[(src, dst)] = TierPairMeasurement(
            src=src, dst=dst, transfers=int(b["transfers"]),
            nbytes=int(b["bytes"]), busy_s=float(b["busy_s"]))
    return out


def _eligible(m: TierPairMeasurement, min_transfers: int,
              min_bytes: int) -> bool:
    return (m.transfers >= min_transfers and m.nbytes >= min_bytes
            and m.busy_s > 0)


@dataclass(frozen=True)
class CalibratedHardwareSpec(HardwareSpec):
    """A ``HardwareSpec`` whose pool bandwidths are measured, not assumed.

    Drop-in for the planner (same ``transfer_time`` interface, now backed
    by measured numbers); carries the full per-pair bandwidth table for
    N-tier topologies where a single d2r/r2d scalar can't express every
    link. The name is suffixed ``+measured`` so plan caches keyed on
    ``hw.name`` never alias a calibrated plan with a static one."""

    pair_bw: Tuple[Tuple[str, str, float], ...] = ()

    def bandwidth_between(self, src: str, dst: str) -> Optional[float]:
        """Measured bytes/s over one directed link (None = not measured)."""
        for s, d, bw in self.pair_bw:
            if s == src and d == dst:
                return bw
        return None


def calibrate(base: HardwareSpec,
              measurements: Mapping[Tuple[str, str], TierPairMeasurement], *,
              device_tier: str = "device",
              min_transfers: int = MIN_TRANSFERS,
              min_bytes: int = MIN_BYTES) -> CalibratedHardwareSpec:
    """Fold measured per-pair bandwidth into a planner spec.

    Every eligible pair lands in ``pair_bw``; the scalar pool bandwidths
    the cost model consumes aggregate byte-weighted across pairs touching
    ``device_tier`` — reads into it set ``pool_bw_r2d``, writes out of it
    set ``pool_bw_d2r``. Directions with no eligible data keep ``base``'s
    static numbers."""
    eligible = {k: m for k, m in measurements.items()
                if _eligible(m, min_transfers, min_bytes)}

    def weighted_bw(ms) -> Optional[float]:
        total_bytes = sum(m.nbytes for m in ms)
        total_busy = sum(m.busy_s for m in ms)
        return total_bytes / total_busy if total_busy > 0 else None

    r2d = weighted_bw([m for (s, d), m in eligible.items()
                       if d == device_tier and s != device_tier])
    d2r = weighted_bw([m for (s, d), m in eligible.items()
                       if s == device_tier and d != device_tier])
    fields = asdict(base)
    fields.pop("pair_bw", None)   # re-calibrating an already-calibrated spec
    fields["name"] = f"{base.name.split('+measured')[0]}+measured"
    if r2d is not None:
        fields["pool_bw_r2d"] = r2d
    if d2r is not None:
        fields["pool_bw_d2r"] = d2r
    pair_bw = tuple(sorted((m.src, m.dst, m.bandwidth)
                           for m in eligible.values()))
    return CalibratedHardwareSpec(pair_bw=pair_bw, **fields)


def required_inflight(
        measurements: Mapping[Tuple[str, str], TierPairMeasurement], *,
        pages_per_step: float, window_s: float,
        device_tier: str = "device", cap: int = 64,
        min_transfers: int = MIN_TRANSFERS,
        min_bytes: int = MIN_BYTES) -> int:
    """In-flight transfer parallelism needed to complete one step's
    fetches inside the overlap window — the measured bandwidth-delay
    product. The window is clamped below at one mean transfer time:
    transfers can't be spread thinner than one of themselves, so a
    window at or under ``mean_t`` degrades to the latency-dominated
    answer — every one of the step's fetches genuinely concurrent
    (``ceil(pages_per_step)``). Returns 0 when there is no evidence
    (no eligible read pair, or a degenerate window): callers leave the
    engine alone."""
    if pages_per_step <= 0 or window_s <= 0:
        return 0
    reads = [m for (s, d), m in measurements.items()
             if d == device_tier and s != device_tier
             and _eligible(m, min_transfers, min_bytes)]
    total_transfers = sum(m.transfers for m in reads)
    if not total_transfers:
        return 0
    mean_t = sum(m.busy_s for m in reads) / total_transfers
    need = math.ceil(pages_per_step * mean_t / max(window_s, mean_t))
    return max(1, min(int(need), int(cap)))
