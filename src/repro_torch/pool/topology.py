"""Declarative tier topology: the memory hierarchy as data, not literals.

The PyTorch port's own copy of ``repro.pool.topology`` (same specs, same
validation). A ``TierTopology`` is an ordered chain of ``TierSpec``s — each
names one tier, its storage backend kind, its capacity, whether admission
control may count it, and (for ``modeled`` tiers) the latency/bandwidth the
backend *enforces* by sleep-throttling each transfer.

``TierTopology.default()`` is the standard device → host → remote chain,
with admission counting device + host and an *unthrottled* modeled tier in
the remote slot.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

TIER_KINDS = ("device", "host", "numpy", "modeled")


@dataclass(frozen=True)
class TierSpec:
    """One tier in the chain.

    ``kind`` selects the storage backend (``pool.backend.backend_for``):

    - ``device``  — the pool's device (CUDA memory; must be the chain's
      first tier);
    - ``host``    — host memory: pinned CPU tensors when the pool's device
      is CUDA, plain CPU tensors when it is the CPU;
    - ``numpy``   — plain (pageable) CPU tensors;
    - ``modeled`` — plain CPU tensors behind a sleep-throttle that enforces
      ``read_bw``/``write_bw`` (bytes/s, None → unthrottled) plus
      ``read_latency_s``/``write_latency_s`` per transfer. The only kind
      the throttle fields are valid for.

    ``capacity`` is the tier's byte budget (None → unbounded), ``admit``
    marks it countable by admission control.
    """

    name: str
    kind: str = "modeled"
    capacity: Optional[int] = None
    admit: bool = True
    read_bw: Optional[float] = None        # tier → device, bytes/s
    write_bw: Optional[float] = None       # device → tier, bytes/s
    read_latency_s: float = 0.0
    write_latency_s: float = 0.0

    def __post_init__(self) -> None:
        if not self.name or not isinstance(self.name, str):
            raise ValueError("TierSpec.name must be a non-empty string")
        if self.kind not in TIER_KINDS:
            raise ValueError(
                f"TierSpec.kind must be one of {TIER_KINDS}, got {self.kind!r}")
        if self.capacity is not None and self.capacity < 0:
            raise ValueError("TierSpec.capacity must be >= 0 or None")
        for bw_name in ("read_bw", "write_bw"):
            bw = getattr(self, bw_name)
            if bw is not None and bw <= 0:
                raise ValueError(f"TierSpec.{bw_name} must be > 0 or None")
        for lat_name in ("read_latency_s", "write_latency_s"):
            if getattr(self, lat_name) < 0:
                raise ValueError(f"TierSpec.{lat_name} must be >= 0")
        if self.kind != "modeled" and self.throttled:
            raise ValueError(
                f"tier {self.name!r}: latency/bandwidth fields are only "
                f"valid for kind='modeled' (got kind={self.kind!r} — real "
                "backends have whatever character the hardware gives them)")

    @property
    def throttled(self) -> bool:
        return (self.read_bw is not None or self.write_bw is not None
                or self.read_latency_s > 0 or self.write_latency_s > 0)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TierSpec":
        unknown = set(d) - {f for f in cls.__dataclass_fields__}
        if unknown:
            raise ValueError(f"unknown TierSpec keys: {sorted(unknown)}")
        return cls(**dict(d))


@dataclass(frozen=True)
class TierTopology:
    """An ordered spill chain of ``TierSpec``s, top (fastest) first.

    Invariants: at least one tier; unique names; a ``device``-kind tier, if
    present, is the first (spill-down only moves away from the
    accelerator); at least one tier admits.
    """

    tiers: Tuple[TierSpec, ...] = field(default_factory=tuple)

    def __post_init__(self) -> None:
        tiers = tuple(self.tiers)
        object.__setattr__(self, "tiers", tiers)
        if not tiers:
            raise ValueError("TierTopology needs at least one tier")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names in topology: {names}")
        for i, t in enumerate(tiers):
            if t.kind == "device" and i != 0:
                raise ValueError(
                    f"device-kind tier {t.name!r} must be the chain's first "
                    "tier (spill-down moves away from the accelerator)")
        if not any(t.admit for t in tiers):
            raise ValueError("at least one tier must admit")

    @classmethod
    def default(cls, *, device_capacity: Optional[int] = None,
                host_capacity: Optional[int] = None,
                remote_capacity: Optional[int] = None) -> "TierTopology":
        """The standard three-tier chain: device → host → remote, with
        admission counting device + host and an unthrottled modeled tier
        (CPU storage, no latency/bandwidth character) in the remote
        slot."""
        return cls(tiers=(
            TierSpec("device", kind="device", capacity=device_capacity),
            TierSpec("host", kind="host", capacity=host_capacity),
            TierSpec("remote", kind="modeled", capacity=remote_capacity,
                     admit=False),
        ))

    # ------------------------------------------------------------------
    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tiers)

    @property
    def top(self) -> str:
        """The chain's fastest tier — where pages are parked for compute."""
        return self.tiers[0].name

    @property
    def default_store_tier(self) -> str:
        """Where ``pool.put`` lands when the caller names no tier: the
        first tier *below* the top (classic offload target), or the only
        tier of a single-tier chain."""
        return self.tiers[1].name if len(self.tiers) > 1 else self.tiers[0].name

    @property
    def admission_tiers(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tiers if t.admit)

    def spec(self, name: str) -> TierSpec:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier named {name!r} in topology {self.names}")

    def __iter__(self) -> Iterator[TierSpec]:
        return iter(self.tiers)

    def __len__(self) -> int:
        return len(self.tiers)

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"tiers": [t.to_dict() for t in self.tiers]}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TierTopology":
        unknown = set(d) - {"tiers"}
        if unknown:
            raise ValueError(f"unknown TierTopology keys: {sorted(unknown)}")
        specs = d.get("tiers", ())
        return cls(tiers=tuple(
            s if isinstance(s, TierSpec) else TierSpec.from_dict(s)
            for s in specs))
