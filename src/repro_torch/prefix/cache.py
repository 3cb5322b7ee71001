"""Cross-request prefix KV cache over the memory-pool tiers (the port's
copy of ``repro.prefix.cache``).

``PrefixCacheManager`` makes shared prompt prefixes first-class,
ref-counted pool citizens: each cached page (``page_size`` tokens × one
KV slice per layer leaf) is a ``MemoryPoolManager`` entry, indexed by the
token-id radix tree in ``prefix.index``. The serving scheduler consults it
at admission (``lookup`` — a hit maps the shared pages into the request's
row cache and prefill starts at the match offset) and feeds it at
retirement (``donate`` — the retired prompt's full prefix pages enter the
cache instead of being freed).

Sharing is **copy-on-write by construction**: a hit *copies* the shared
page contents into the admitted request's own row cache, and the request
parks/overwrites only its own copies from then on — the cached entries are
never written after donation, so any number of concurrent readers share
one physical page per tier.

Tiering and lifetime follow the pool's priority+LRU manager:

- cached pages are stored device-resident at priority 0.0 — *below* any
  live request's parked pages, so under device pressure prefix pages age
  down to host before request state does, and LRU keeps the *hot*
  prefixes (recently matched — every hit refreshes the pool LRU clock via
  the fetch) device-resident while cold ones spill;
- while a page is ref'd by a running request its entries are **pinned**
  (the pool's victim scan skips them), so eviction can never pull a page
  out from under a reader; the pins drop on the final ``release``;
- ``pin_tier`` is the residency floor: a page the pool spills *below* it
  (e.g. host → remote with the default ``pin_tier="host"``) is deemed
  cheaper to recompute than to fetch back, and the eviction listener
  **invalidates** it — the node and every deeper node (a longer prefix is
  meaningless without one of its pages) leave the index and the pool;
- ``max_pages`` bounds the cache's own footprint: donations beyond it
  evict the coldest unref'd leaf pages first, and are rejected outright
  when everything is ref'd.

The manager is layout-agnostic: pages are opaque ``label -> tensor`` dicts
(the scheduler uses its ``L{layer}.{leaf}`` page labels), so nothing here
depends on model internals. A donated tensor may be a view of a live cache
(the scheduler slices pages out of its batch cache): the pool's ``put``
stores a copy, and the manager keeps nothing of ``extract``'s dict after
the puts, so later writes to that cache never reach a cached page.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.obs import NULL_TRACER
from repro_torch.pool import HOST_TIER
from repro_torch.pool.manager import (
    MemoryPoolManager, PoolCapacityError, PoolEntry,
)
from repro_torch.prefix.index import PrefixNode, RadixPrefixIndex

_PREFIX_IDS = itertools.count()

#: priority of cached prefix pages in the pool: below any live request's
#: parked pages (priority >= 1.0), so prefix pages age down first and a
#: running request's state is never displaced by a cache optimization.
PREFIX_PAGE_PRIORITY = 0.0


@dataclass
class PrefixCacheStats:
    hits: int = 0
    misses: int = 0
    hit_pages: int = 0
    hit_tokens: int = 0            # prefill tokens served from cache
    donations: int = 0
    donated_pages: int = 0
    rejected_donations: int = 0    # budget full of ref'd pages
    evictions: int = 0             # pages dropped by the max_pages budget
    invalidations: int = 0         # pages dropped by the pin_tier floor
    releases: int = 0

    def snapshot(self) -> Dict[str, float]:
        return dict(self.__dict__)


@dataclass
class PrefixHit:
    """One admission-time match: the chain of shared pages a request reads
    (refs held until ``PrefixCacheManager.release``)."""

    nodes: List[PrefixNode]
    page_size: int
    released: bool = field(default=False, repr=False)

    @property
    def n_pages(self) -> int:
        return len(self.nodes)

    @property
    def tokens(self) -> int:
        """Prompt tokens covered — where suffix prefill starts."""
        return len(self.nodes) * self.page_size

    def page_keys(self) -> List[Dict[str, str]]:
        """Per matched page (shallowest first): page label -> pool key."""
        return [dict(n.entries) for n in self.nodes]


class PrefixCacheManager:
    """Radix-indexed, ref-counted prefix-KV page cache (see module doc).

    Single-threaded by design, like the scheduler that drives it; the only
    reentrant path is the pool's eviction listener, which the pool calls
    under its own (reentrant) lock.
    """

    def __init__(self, pool: MemoryPoolManager, *, page_size: int,
                 max_pages: Optional[int] = None, min_match_pages: int = 1,
                 pin_tier: str = HOST_TIER, tracer=None) -> None:
        if max_pages is not None and max_pages < 1:
            raise ValueError("max_pages must be >= 1 (or None = unbounded)")
        if min_match_pages < 1:
            raise ValueError("min_match_pages must be >= 1")
        if pin_tier not in pool.spill_order:
            raise ValueError(f"pin_tier {pin_tier!r} not in pool tiers "
                             f"{pool.spill_order}")
        self.pool = pool
        self.page_size = page_size
        self.max_pages = max_pages
        self.min_match_pages = min_match_pages
        self.pin_tier = pin_tier
        self.index = RadixPrefixIndex(page_size)
        self.stats = PrefixCacheStats()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._ns = f"pfx{next(_PREFIX_IDS)}"
        self._owner: Dict[str, PrefixNode] = {}   # pool key -> owning node
        self._floor = pool.spill_order.index(pin_tier)
        # pool keys invalidated from inside the evict listener; dropped at
        # the next manager call (see _on_evict)
        self._deferred_drops: List[str] = []
        pool.add_evict_listener(self._on_evict)
        self._closed = False

    # -- observability -------------------------------------------------
    def __len__(self) -> int:
        """Cached pages (== index nodes)."""
        return len(self.index)

    @property
    def live_refs(self) -> int:
        return sum(n.refs for n in self.index.nodes.values())

    def snapshot(self) -> Dict[str, float]:
        out = self.stats.snapshot()
        out["pages"] = len(self.index)
        out["refs"] = self.live_refs
        out["pinned_pages"] = sum(
            1 for n in self.index.nodes.values() if n.refs > 0)
        return out

    # -- admission-side ------------------------------------------------
    def lookup(self, tokens: np.ndarray, *,
               max_tokens: Optional[int] = None) -> Optional[PrefixHit]:
        """Match ``tokens`` against the cached prefixes and take a read
        ref on every matched page (pinning it against eviction) until the
        caller ``release``s the hit. ``max_tokens`` caps the match — the
        scheduler passes ``prompt_len - 1`` so at least one real token
        remains to prefill (the first sampled token needs its logits).
        Returns None on a miss (or a match shorter than
        ``min_match_pages``)."""
        self._flush_deferred()
        max_pages = None if max_tokens is None else max_tokens // self.page_size
        chain = self.index.match(tokens, max_pages)
        if len(chain) < self.min_match_pages:
            self.stats.misses += 1
            if self.tracer.enabled:
                self.tracer.instant("prefix", "lookup",
                                    {"hit": False, "pages": 0})
            return None
        for node in chain:
            node.refs += 1
            node.hits += 1
            if node.refs == 1:
                for key in node.entries.values():
                    self.pool.pin(key, True)
        self.stats.hits += 1
        self.stats.hit_pages += len(chain)
        self.stats.hit_tokens += len(chain) * self.page_size
        if self.tracer.enabled:
            self.tracer.instant(
                "prefix", "lookup",
                {"hit": True, "pages": len(chain),
                 "tokens": len(chain) * self.page_size})
        return PrefixHit(nodes=chain, page_size=self.page_size)

    def release(self, hit: PrefixHit) -> None:
        """Drop the hit's read refs (idempotent); a page's entries unpin —
        becoming evictable again — only on the *final* release."""
        if hit.released:
            return
        hit.released = True
        self._flush_deferred()
        self.stats.releases += 1
        for node in hit.nodes:
            node.refs -= 1
            if node.refs == 0 and node.node_id in self.index.nodes:
                for key in node.entries.values():
                    if key in self.pool:
                        self.pool.pin(key, False)

    # -- retirement-side -----------------------------------------------
    def donate(self, tokens: np.ndarray, n_pages: int,
               extract: Callable[[int], Mapping[str, torch.Tensor]]) -> int:
        """Insert the first ``n_pages`` pages of a retired prompt.
        ``extract(page_idx)`` supplies ``label -> KV slice`` for one page
        and is called **only for pages not already cached** (re-donating a
        popular prefix is a pure LRU refresh). Returns the number of pages
        actually added; pages that don't fit under ``max_pages`` after
        evicting every unref'd cold page are rejected."""
        if n_pages < 1:
            return 0
        self._flush_deferred()
        chain, created = self.index.insert(tokens, n_pages)
        if not created:
            return 0
        self.stats.donations += 1
        added = 0
        for node in created:
            if node.node_id not in self.index.nodes:
                # detached when a shallower page of this same donation was
                # rejected (a chain is only as valid as its shallowest page)
                self.stats.rejected_donations += 1
                continue
            if not self._make_budget_room(node):
                self._discard(node)
                self.stats.rejected_donations += 1
                continue
            try:
                for label, value in extract(node.depth - 1).items():
                    key = f"{self._ns}/n{node.node_id}/{label}"
                    self.pool.put(key, value, self.pool.top_tier,
                                  priority=PREFIX_PAGE_PRIORITY)
                    node.entries[label] = key
                    self._owner[key] = node
            except PoolCapacityError:
                # every tier full of unevictable data — undo this node
                self._drop_node_entries(node)
                self._discard(node)
                self.stats.rejected_donations += 1
                continue
            if node.node_id not in self.index.nodes:
                # a spill cascade triggered by this donation's own puts
                # invalidated the node mid-store — undo what's left of it
                self._drop_node_entries(node)
                self.stats.rejected_donations += 1
                continue
            added += 1
            self.stats.donated_pages += 1
        self._flush_deferred()
        if self.tracer.enabled:
            self.tracer.instant("prefix", "donate",
                                {"pages": added, "offered": n_pages})
        return added

    # -- internals -----------------------------------------------------
    def _discard(self, node: PrefixNode) -> None:
        """Remove a node that never became (or no longer is) a valid cache
        page. Descendants created in the same donation are handled by
        their own loop iteration (a parentless node rejects its subtree:
        removing it detaches them from the index)."""
        for n in self.index.remove(node):
            self._drop_node_entries(n)

    def _drop_node_entries(self, node: PrefixNode) -> None:
        for key in node.entries.values():
            self._owner.pop(key, None)
            if key in self.pool:
                self.pool.drop(key)
        node.entries.clear()

    def _make_budget_room(self, node: PrefixNode) -> bool:
        """Evict coldest unref'd leaf pages until the index (which already
        counts ``node`` — ``insert`` adds created nodes up front) fits
        under ``max_pages``. ``node`` itself is never a victim, and its
        ancestors are interior while it lives, so the chain being donated
        is safe. False if the budget is full of ref'd/interior pages."""
        if self.max_pages is None:
            return True
        while len(self.index) > self.max_pages:
            victims = [v for v in self.index.evictable() if v is not node]
            if not victims:
                return False
            self._discard(victims[0])
            self.stats.evictions += 1
        return True

    def _on_evict(self, entry: PoolEntry, dst: str) -> None:
        """Pool spill listener: a page falling *below* the ``pin_tier``
        floor is invalidated — pruned from the index (with every deeper
        page of its chain) immediately, but its pool entries are only
        *queued* for dropping. The listener runs inside the pool's
        eviction path, and a chain invalidation can name an entry that is
        itself mid-eviction further up the stack (the victim whose spill
        cascaded into this one) — dropping it here would corrupt the tier
        accounting when its eviction frame resumes. The queued keys are
        dropped at the next manager call (``_flush_deferred``)."""
        node = self._owner.get(entry.key)
        if node is None:
            return
        if self.pool.spill_order.index(dst) <= self._floor:
            return   # still at/above the floor: cold but valid
        removed = self.index.remove(node)
        for n in removed:
            for key in n.entries.values():
                self._owner.pop(key, None)
                self._deferred_drops.append(key)
            n.entries.clear()
        self.stats.invalidations += len(removed)
        if self.tracer.enabled:
            self.tracer.instant("prefix", "invalidate",
                                {"pages": len(removed), "below": dst})

    def _flush_deferred(self) -> None:
        while self._deferred_drops:
            key = self._deferred_drops.pop()
            if key in self.pool:
                self.pool.drop(key)

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        """Unhook from the (possibly shared) pool and drop every cached
        page. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.pool.remove_evict_listener(self._on_evict)
        self._flush_deferred()
        for node in list(self.index.nodes.values()):
            self._drop_node_entries(node)
        self.index = RadixPrefixIndex(self.page_size)
        self._owner.clear()
