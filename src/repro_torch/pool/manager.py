"""Capacity-tracked memory-pool manager over the tiered backends.

The counterpart of ``repro.pool.manager``. ``MemoryPoolManager`` owns an
ordered spill chain of tiers, described by a ``TierTopology``
(``default_pool`` builds the standard device → host → remote chain). Each
``put`` is charged against the tier's byte capacity; when a tier is full,
victims are chosen by (priority, then LRU) among unpinned entries and
**spilled** to the next tier down the chain. Only when the last tier is full
does a put fail with ``PoolCapacityError``. Listeners registered with
``add_evict_listener`` hear of every spill.

Admission control keeps a reservation ledger beside the tiers
(``reserve``/``release``): the serving scheduler admits a request only when
its worst-case pages fit in the admitting tiers on top of their occupancy
and every standing reservation.

All traffic is counted (puts/gets/evictions, bytes in/out, per-tier
occupancy and high-water mark) and surfaced by ``snapshot()``; synchronous
movement (puts, spills, blocking gets) also lands in the transfer engine's
per tier-pair table.

Re-putting a key whose entry sits in the same tier copies into the entry's
existing buffer when shape and type match — the serving engine re-puts the
same cache leaves every decode step, and pinning a fresh host buffer each
time would dominate the step.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.pool import backend as B
from repro_torch.pool.topology import TierTopology
from repro_torch.pool.transfer import TransferEngine, TransferHandle


class PoolCapacityError(RuntimeError):
    """Every tier is full (after spilling) — the put cannot be honored."""


@dataclass
class PoolEntry:
    key: str
    tier: str
    handle: Any
    nbytes: int
    priority: float = 0.0      # higher → evicted later
    pinned: bool = False       # never chosen as an eviction victim
    last_use: int = 0          # LRU clock
    #: prefetches of this entry not yet known to have run; a re-put that
    #: reuses the entry's buffer waits for them first
    pending: List[TransferHandle] = field(default_factory=list)


@dataclass
class TierState:
    name: str
    backend: B.MemoryBackend
    capacity: Optional[int] = None     # bytes; None → unbounded
    used: int = 0
    peak: int = 0

    def room_for(self, nbytes: int) -> bool:
        return self.capacity is None or self.used + nbytes <= self.capacity


@dataclass
class PoolStats:
    puts: int = 0
    gets: int = 0
    evictions: int = 0
    drops: int = 0
    bytes_stored: int = 0
    bytes_fetched: int = 0
    bytes_evicted: int = 0

    def snapshot(self) -> Dict[str, float]:
        return dict(self.__dict__)


class MemoryPoolManager:
    def __init__(self, tiers: Sequence[TierState],
                 transfer: Optional[TransferEngine] = None,
                 tracer=None, topology: Optional[TierTopology] = None) -> None:
        if not tiers:
            raise ValueError("need at least one tier")
        self.tiers: Dict[str, TierState] = {t.name: t for t in tiers}
        self.spill_order: List[str] = [t.name for t in tiers]
        self.topology = topology
        if topology is not None and list(topology.names) != self.spill_order:
            raise ValueError(
                f"topology names {topology.names} do not match tier states "
                f"{self.spill_order}")
        #: where fetched values land: the device of the chain's first tier
        self.device: torch.device = tiers[0].backend.device
        self.entries: Dict[str, PoolEntry] = {}
        self.transfer = transfer or TransferEngine()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None:
            self.transfer.set_tracer(tracer)
        self.stats = PoolStats()
        self._clock = 0
        self._lock = threading.RLock()
        # admission ledger: key -> (nbytes, tiers reserved against, covered
        # key prefix whose entries the reservation pays for)
        self._reservations: Dict[
            str, Tuple[int, Tuple[str, ...], Optional[str]]] = {}
        self._evict_listeners: List[Callable[[PoolEntry, str], None]] = []

    # -- topology-derived roles ----------------------------------------
    @property
    def top_tier(self) -> str:
        """The chain's fastest tier — where compute-resident pages park."""
        return self.spill_order[0]

    @property
    def default_store_tier(self) -> str:
        """Where ``put`` lands when the caller names no tier: the
        topology's store tier, else ``host`` when such a tier exists, else
        the first off-device tier of the chain."""
        if self.topology is not None:
            return self.topology.default_store_tier
        if B.HOST_TIER in self.tiers:
            return B.HOST_TIER
        for name in self.spill_order:
            if not isinstance(self._tier(name).backend, B.DeviceBackend):
                return name
        return self.spill_order[-1]

    @property
    def admission_tiers(self) -> Tuple[str, ...]:
        """Tiers admission control counts a request's worst-case pages
        against: the topology's ``admit`` declarations; for a pool without
        a topology, its device and host tiers (else every tier above the
        last)."""
        if self.topology is not None:
            return self.topology.admission_tiers
        legacy = tuple(n for n in self.spill_order
                       if n in (B.DEVICE_TIER, B.HOST_TIER))
        if legacy:
            return legacy
        return tuple(self.spill_order[:-1]) or (self.spill_order[0],)

    # -- storing -------------------------------------------------------
    def put(self, key: str, value: torch.Tensor, tier: Optional[str] = None,
            *, priority: float = 0.0, pinned: bool = False) -> PoolEntry:
        """Store a snapshot of ``value`` into ``tier`` (default: the pool's
        ``default_store_tier``), evicting (spilling down-hierarchy) as
        needed. Re-putting an existing key replaces it; if the new value
        doesn't fit, the old entry survives untouched."""
        if tier is None:
            tier = self.default_store_tier
        prior = self.entries.get(key)
        if prior is not None:
            # its queued fetches must have read the buffer before a reuse
            # overwrites it (waited outside the lock: the fetches take it)
            self._settle(prior)
        t0 = self.tracer.now() if self.tracer.enabled else 0.0
        with self._lock:
            st = self._tier(tier)
            nbytes = int(st.backend.wire_nbytes(value))
            old = self.entries.pop(key, None)
            if old is not None:
                self._tier(old.tier).used -= old.nbytes
            try:
                self._make_room(st, nbytes)
            except PoolCapacityError:
                if old is not None:   # restore — a failed put loses nothing
                    self.entries[key] = old
                    self._tier(old.tier).used += old.nbytes
                raise
            reuse = old.handle if old is not None and old.tier == tier else None
            t_x = time.perf_counter()
            handle = st.backend.put(value, reuse=reuse)
            if not isinstance(st.backend, B.DeviceBackend):
                self.transfer.record_pair(B.DEVICE_TIER, tier, nbytes,
                                          time.perf_counter() - t_x)
            self._clock += 1
            entry = PoolEntry(key=key, tier=tier, handle=handle,
                              nbytes=nbytes, priority=priority,
                              pinned=pinned, last_use=self._clock)
            self.entries[key] = entry
            st.used += nbytes
            st.peak = max(st.peak, st.used)
            self.stats.puts += 1
            self.stats.bytes_stored += nbytes
            if self.tracer.enabled:
                self.tracer.complete("pool", "put", t0, self.tracer.now() - t0,
                                     {"key": key, "tier": tier,
                                      "nbytes": nbytes})
            return entry

    # -- fetching ------------------------------------------------------
    def get(self, key: str) -> torch.Tensor:
        """Materialize the entry on the pool's device (a new tensor the
        caller owns), ordered on the caller's current stream."""
        t0 = self.tracer.now() if self.tracer.enabled else 0.0
        with self._lock:
            entry = self.entries[key]
            self._clock += 1
            entry.last_use = self._clock
            self.stats.gets += 1
            self.stats.bytes_fetched += entry.nbytes
            backend, handle = self._tier(entry.tier).backend, entry.handle
        t_x = time.perf_counter()
        value = backend.get(handle)
        if not isinstance(backend, B.DeviceBackend):
            self.transfer.record_pair(entry.tier, B.DEVICE_TIER, entry.nbytes,
                                      time.perf_counter() - t_x)
        if self.tracer.enabled:
            self.tracer.complete("pool", "fetch", t0, self.tracer.now() - t0,
                                 {"key": key, "tier": entry.tier,
                                  "nbytes": entry.nbytes})
        return value

    def prefetch(self, key: str) -> TransferHandle:
        """Issue an async device fetch through the transfer engine; the
        returned handle's ``wait()`` yields the device tensor."""
        with self._lock:
            entry = self.entries[key]   # fail fast on unknown keys
            backend, handle = self._tier(entry.tier).backend, entry.handle
            src = entry.tier

        def fetch():
            with self._lock:
                self._clock += 1
                entry.last_use = self._clock
                self.stats.gets += 1
                self.stats.bytes_fetched += entry.nbytes
            return backend.get(handle)

        h = self.transfer.submit(fetch, key=key, src=src, dst=B.DEVICE_TIER,
                                 nbytes=entry.nbytes, device=self.device)
        with self._lock:
            entry.pending = [p for p in entry.pending
                             if not p._future.done()] + [h]
        return h

    # -- bookkeeping ---------------------------------------------------
    def close(self) -> None:
        """Drain and shut down the transfer engine's worker threads."""
        self.transfer.close()

    def drop(self, key: str) -> None:
        with self._lock:
            self._forget(key)
            self.stats.drops += 1

    def pin(self, key: str, pinned: bool = True) -> None:
        with self._lock:
            self.entries[key].pinned = pinned

    def set_priority(self, key: str, priority: float) -> None:
        """Re-rank an entry for eviction without touching its data (no-op
        for keys not in the pool)."""
        with self._lock:
            entry = self.entries.get(key)
            if entry is not None:
                entry.priority = priority

    # -- admission control (capacity reservation) ----------------------
    def reserve(self, key: str, nbytes: int,
                tiers: Optional[Sequence[str]] = None,
                covers: Optional[str] = None,
                itemsize: Optional[int] = None) -> bool:
        """Reserve ``nbytes`` of worst-case capacity against the combined
        byte budget of ``tiers`` (default: every tier): it fits when the
        tiers' occupancy plus every standing reservation plus ``nbytes``
        stays within their capacity. Reservations are bookkeeping only and
        never block ``put``. ``covers`` names a key prefix whose entries
        this reservation pays for: their occupancy is left out of the
        check, so a running request's parked pages are not counted twice.
        ``itemsize`` is the decoded element size of the reserved pages
        (see :meth:`tier_scale`). Returns False, and records nothing, when
        it does not fit; re-reserving a key replaces it. A tier of
        unbounded capacity makes every reservation fit."""
        with self._lock:
            tiers = tuple(tiers) if tiers is not None \
                else tuple(self.spill_order)
            old = self._reservations.pop(key, None)
            cap, used, unbounded = self._capacity_used(tiers, itemsize)
            if not unbounded:
                held = sum(n for n, ts, _ in self._reservations.values()
                           if set(ts) & set(tiers))
                if used + held + int(nbytes) > cap:
                    if old is not None:
                        self._reservations[key] = old
                    return False
            self._reservations[key] = (int(nbytes), tiers, covers)
            return True

    def release(self, key: str) -> None:
        """Drop a reservation (no-op if absent)."""
        with self._lock:
            self._reservations.pop(key, None)

    def reserved_bytes(self, tiers: Optional[Sequence[str]] = None) -> int:
        with self._lock:
            if tiers is None:
                return sum(n for n, _, _ in self._reservations.values())
            want = set(tiers)
            return sum(n for n, ts, _ in self._reservations.values()
                       if set(ts) & want)

    def headroom(self, tiers: Sequence[str],
                 itemsize: Optional[int] = None) -> Optional[int]:
        """Free bytes across ``tiers`` after occupancy (reservation-covered
        entries excluded) and standing reservations (None = unbounded)."""
        with self._lock:
            cap, used, unbounded = self._capacity_used(tiers, itemsize)
            if unbounded:
                return None
            return cap - used - self.reserved_bytes(tiers)

    def tier_scale(self, name: str, itemsize: Optional[int]) -> float:
        """On-wire bytes per decoded byte for entries at rest in ``name``.
        Always 1.0 here: no tier of the port encodes its pages (the page
        codecs are not ported), so a page occupies its decoded size."""
        self._tier(name)
        return 1.0

    def _capacity_used(self, tiers: Sequence[str],
                       itemsize: Optional[int] = None
                       ) -> Tuple[int, int, bool]:
        """(capacity, occupancy net of covered entries, any unbounded)
        across ``tiers``, each tier's bytes divided by its
        :meth:`tier_scale`. Covered entries (key under a reservation's
        ``covers`` prefix) are charged through their reservation."""
        cap = used = 0.0
        unbounded = False
        names = set(tiers)
        prefixes = tuple(c for _, ts, c in self._reservations.values()
                         if c is not None and set(ts) & names)
        for t in tiers:
            st = self._tier(t)
            if st.capacity is None:
                unbounded = True
                continue
            scale = self.tier_scale(t, itemsize)
            tier_used = st.used
            if prefixes:
                tier_used -= sum(e.nbytes for e in self.entries.values()
                                 if e.tier == t and e.key.startswith(prefixes))
            cap += st.capacity / scale
            used += tier_used / scale
        # floor capacity / ceil occupancy: rounding never over-admits
        return int(math.floor(cap)), int(math.ceil(used)), unbounded

    # -- eviction notification -----------------------------------------
    def add_evict_listener(self, cb: Callable[[PoolEntry, str], None]) -> None:
        """Register ``cb(entry, dst_tier)``, called under the pool's
        (reentrant) lock after an entry spills down the chain."""
        with self._lock:
            self._evict_listeners.append(cb)

    def remove_evict_listener(self,
                              cb: Callable[[PoolEntry, str], None]) -> None:
        """Unregister a listener (no-op if absent)."""
        with self._lock:
            if cb in self._evict_listeners:
                self._evict_listeners.remove(cb)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def tier_of(self, key: str) -> str:
        return self.entries[key].tier

    def is_host_resident(self, key: str) -> bool:
        """The entry lives off-device AND its handle checks out where its
        tier claims."""
        entry = self.entries[key]
        st = self._tier(entry.tier)
        return (not isinstance(st.backend, B.DeviceBackend)
                and st.backend.holds(entry.handle))

    def occupancy(self, tier: str) -> Tuple[int, Optional[int]]:
        st = self._tier(tier)
        return st.used, st.capacity

    def snapshot(self) -> Dict[str, Any]:
        """Stats + per-tier occupancy, for benchmarks/serving to print."""
        with self._lock:
            out: Dict[str, Any] = self.stats.snapshot()
            out["transfer"] = self.transfer.stats.snapshot()
            out["reserved"] = self.reserved_bytes()
            for name, st in self.tiers.items():
                out[f"tier/{name}"] = {
                    "backend": st.backend.name, "used": st.used,
                    "peak": st.peak, "capacity": st.capacity,
                    "entries": sum(1 for e in self.entries.values()
                                   if e.tier == name),
                }
            return out

    # -- internals -----------------------------------------------------
    def _tier(self, name: str) -> TierState:
        try:
            return self.tiers[name]
        except KeyError:
            raise KeyError(f"unknown tier {name!r}; have {list(self.tiers)}")

    @staticmethod
    def _settle(entry: PoolEntry) -> None:
        for h in entry.pending:
            try:
                h._future.result()
            except Exception:
                pass   # the failure belongs to that handle's wait()
        entry.pending = []

    def _forget(self, key: str) -> None:
        entry = self.entries.pop(key)
        self._tier(entry.tier).used -= entry.nbytes

    def _next_tier(self, name: str) -> Optional[str]:
        i = self.spill_order.index(name)
        return self.spill_order[i + 1] if i + 1 < len(self.spill_order) else None

    def _make_room(self, st: TierState, nbytes: int) -> None:
        while not st.room_for(nbytes):
            victim = self._pick_victim(st.name)
            if victim is None:
                raise PoolCapacityError(
                    f"tier {st.name!r}: need {nbytes} bytes, "
                    f"{st.used}/{st.capacity} used, nothing evictable")
            self._evict(victim)

    def _pick_victim(self, tier: str) -> Optional[PoolEntry]:
        candidates = [e for e in self.entries.values()
                      if e.tier == tier and not e.pinned]
        if not candidates:
            return None
        # lowest priority first; LRU breaks ties
        return min(candidates, key=lambda e: (e.priority, e.last_use))

    def _evict(self, entry: PoolEntry) -> None:
        """Spill one entry to the next tier down (or fail at the bottom)."""
        dst = self._next_tier(entry.tier)
        if dst is None:
            raise PoolCapacityError(
                f"cannot evict {entry.key!r}: {entry.tier!r} is the last tier")
        src_st, dst_st = self._tier(entry.tier), self._tier(dst)
        new_nbytes = int(dst_st.backend.wire_nbytes(entry.handle))
        self._make_room(dst_st, new_nbytes)
        t_x = time.perf_counter()
        entry.handle = dst_st.backend.put(entry.handle)
        self.transfer.record_pair(src_st.name, dst, new_nbytes,
                                  time.perf_counter() - t_x)
        src_st.used -= entry.nbytes
        dst_st.used += new_nbytes
        dst_st.peak = max(dst_st.peak, dst_st.used)
        entry.tier = dst
        entry.nbytes = new_nbytes
        self.stats.evictions += 1
        self.stats.bytes_evicted += new_nbytes
        if self.tracer.enabled:
            self.tracer.instant("pool", "spill",
                                {"key": entry.key, "src": src_st.name,
                                 "dst": dst, "nbytes": new_nbytes})
        for cb in self._evict_listeners:
            cb(entry, dst)


# ---------------------------------------------------------------------------


def default_pool(host_capacity: Optional[int] = None,
                 remote_capacity: Optional[int] = None,
                 device_capacity: Optional[int] = None,
                 device: DeviceLike = None,
                 transfer: Optional[TransferEngine] = None, *,
                 topology: Optional[TierTopology] = None,
                 transfer_depth: Optional[int] = None,
                 transfer_workers: int = 2,
                 tracer=None) -> MemoryPoolManager:
    """Build a pool from a declarative ``TierTopology`` — by default the
    standard three-tier chain: device → host → modeled remote (unthrottled).
    ``device`` defaults to CUDA (``device="cpu"`` runs the whole chain in
    CPU memory). Capacities go either through the per-tier kwargs (the
    default chain only) or inside an explicit ``topology`` — never both."""
    dev = resolve_device(device)
    if topology is None:
        topology = TierTopology.default(device_capacity=device_capacity,
                                        host_capacity=host_capacity,
                                        remote_capacity=remote_capacity)
    elif any(c is not None for c in (host_capacity, remote_capacity,
                                     device_capacity)):
        raise ValueError(
            "pass capacities inside the topology's TierSpecs, not alongside "
            "an explicit topology")
    if transfer is None:
        transfer = TransferEngine(depth=transfer_depth or 2,
                                  workers=transfer_workers)
    tiers = [TierState(s.name, B.backend_for(s, dev, transfer.copy_stream),
                       s.capacity) for s in topology.tiers]
    return MemoryPoolManager(tiers, transfer=transfer, tracer=tracer,
                             topology=topology)
