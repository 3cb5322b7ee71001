"""Paged KV cache backed by the runtime memory pool (the counterpart of
``repro.offload.kvcache``), and the continuous scheduler's per-request
page table (``KVPageTable``, sized for admission by
``worst_case_page_bytes``).

Layout per layer: each full page is its own entry in the
``MemoryPoolManager`` (host tier by default — pages are non-contiguous by
construction, as in a paged allocator); the device keeps (a) a *tail*
buffer accumulating the current partial page and (b) per-page key
*summaries* (mean key per page) used for sparse block selection, so only
the top-k relevant pages are reloaded per decode step.

Decode attention runs in two segments — selected pool pages + device tail —
merged in one softmax, so selecting *all* pages reproduces dense attention.
The page fetch is the Prefetch cache operator (``fetch_pages`` through
``pool.get``, or ``prefetch_pages`` through the transfer engine); the page
flush on tail overflow is the Store.

``attend_fused`` attends over an LRU buffer of pages kept on the device,
through a page table, so steady-state decode touches the pool zero times
per step. On a CUDA device it launches the hand-written paged-decode
kernel; on the CPU it runs the kernel's plain version, which is the gather
path's arithmetic bit for bit.

Where the reference rebuilds its tail, summary and page-buffer arrays each
step, the port writes those tensors in place.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
from repro_torch.kernels.ref import (
    paged_attend_gathered,
    paged_decode_attention_ref,
)
from repro_torch.models import runtime
from repro_torch.pool import MemoryPoolManager, TransferHandle, auto_depth

# per-instance pool-key namespace, so caches sharing one pool (e.g. one pool
# across a model's layers) never collide on page keys
_CACHE_IDS = itertools.count()


class KVPageTable:
    """One request's KV pages in the pool — the continuous scheduler's
    per-request page table (``sched.requests``).

    Each page is one (layer, leaf) row of the request's slice of the
    stacked decode cache, stored under a request-stable key: re-parking a
    page replaces the entry in place (and reuses its buffer), and the
    pool's priority+LRU manager decides where it lives — parked on the
    device tier, spilled to the host tier and then to remote under
    capacity pressure, without the table noticing. Admission reserves the
    table's worst case up front (``MemoryPoolManager.reserve``, sized by
    :func:`worst_case_page_bytes`).

    A park stores a snapshot: the pool copies the row (the device tier into
    a buffer of its own, the host tier on the copy stream after the
    producer's stream, synchronized before ``put`` returns), so the caller
    may overwrite the row in place right after — the scheduler's next
    decode step writes the batch cache the pages came from.
    """

    def __init__(self, pool: MemoryPoolManager, name: str) -> None:
        self.pool = pool
        self.key_ns = f"{name}-{next(_CACHE_IDS)}"
        self.keys: Dict[str, str] = {}    # page label -> pool key

    def __len__(self) -> int:
        return len(self.keys)

    def key_of(self, label: str) -> str:
        return self.keys.setdefault(label, f"{self.key_ns}/{label}")

    def park(self, label: str, value: torch.Tensor, tier: str, *,
             priority: float = 0.0) -> str:
        key = self.key_of(label)
        self.pool.put(key, value, tier, priority=priority)
        return key

    def fetch(self, label: str) -> torch.Tensor:
        return self.pool.get(self.keys[label])

    def drop(self) -> None:
        """Retire the request: drop every page still in the pool."""
        for k in self.keys.values():
            if k in self.pool:
                self.pool.drop(k)
        self.keys.clear()


def worst_case_page_bytes(cache_specs: Any) -> int:
    """Worst-case pool footprint of one request's pages: every leaf of the
    per-request cache row at max_seq (``Model.cache_specs(1, max_seq)``,
    tensors on the ``meta`` device). Admission sizes its reservation with
    it before any page exists."""
    if isinstance(cache_specs, torch.Tensor):
        return cache_specs.numel() * cache_specs.element_size()
    items = cache_specs.values() if isinstance(cache_specs, dict) \
        else cache_specs
    return sum(worst_case_page_bytes(v) for v in items)


@dataclasses.dataclass
class PrefetchedPages:
    """In-flight page fetches; ``wait()`` yields what ``fetch_pages``
    would have returned synchronously, plus the page indices."""

    idx: np.ndarray
    k_handles: List[TransferHandle]
    v_handles: List[TransferHandle]
    _empty: torch.Tensor          # (0, B, page, Hkv, D) on the device

    def wait(self) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        if not self.k_handles:
            return self._empty, self._empty, self.idx
        ks = torch.stack([h.wait() for h in self.k_handles])
        vs = torch.stack([h.wait() for h in self.v_handles])
        return ks, vs, self.idx


@dataclasses.dataclass
class PagedKVCache:
    """One attention layer's paged cache. ``n_layers`` instances make a
    model."""

    page_size: int
    n_pages: int               # pool capacity in pages
    batch: int
    n_kv_heads: int
    head_dim: int
    dtype: torch.dtype
    device: torch.device       # the pool's device: tail, summaries, buffer

    pool: MemoryPoolManager    # tiered page store (host tier by default)
    k_pool: List[Optional[str]]   # per page: pool key of the K page, or None
    v_pool: List[Optional[str]]
    k_summary: torch.Tensor    # (n_pages, B, Hkv, D)
    k_tail: torch.Tensor       # (B, page, Hkv, D) — the partial page
    v_tail: torch.Tensor
    length: int = 0            # tokens appended so far
    fetches: int = 0           # pool→device page transfers (stats)
    flushes: int = 0           # device→pool page stores
    key_ns: str = ""           # pool-key namespace (unique per instance)

    # -- fused-decode device page buffer (attend_fused) ----------------
    # LRU slot cache of pages on the device: the fused path attends over it
    # in place via a page table
    device_pages: Optional[int] = None   # slot budget; None → all pages
    buffer_hits: int = 0
    buffer_misses: int = 0
    _kbuf: Optional[torch.Tensor] = None    # (n_slots, B, page, Hkv, D)
    _vbuf: Optional[torch.Tensor] = None
    _slot_of: Dict[int, int] = dataclasses.field(default_factory=dict)
    _slot_page: List[Optional[int]] = dataclasses.field(default_factory=list)
    _slot_use: List[int] = dataclasses.field(default_factory=list)
    _use_clock: int = 0

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, *, batch: int, max_seq: int, page_size: int,
               n_kv_heads: int, head_dim: int,
               dtype: torch.dtype = torch.float32,
               pool: Optional[MemoryPoolManager] = None,
               device_pages: Optional[int] = None) -> "PagedKVCache":
        """A cache on the pool's device (``default_pool(device=...)``)."""
        n_pages = -(-max_seq // page_size)
        if pool is None:
            raise ValueError("PagedKVCache.create() requires a pool "
                             "(repro_torch.pool.default_pool)")
        if device_pages is not None and device_pages < 1:
            raise ValueError("device_pages must be >= 1 (or None = all)")
        pool.transfer.ensure_depth(auto_depth(pages=n_pages))
        dev = pool.device
        tail = (batch, page_size, n_kv_heads, head_dim)
        return cls(
            page_size=page_size, n_pages=n_pages, batch=batch,
            n_kv_heads=n_kv_heads, head_dim=head_dim, dtype=dtype,
            device=dev, pool=pool,
            k_pool=[None] * n_pages, v_pool=[None] * n_pages,
            k_summary=torch.zeros((n_pages, batch, n_kv_heads, head_dim),
                                  dtype=dtype, device=dev),
            k_tail=torch.zeros(tail, dtype=dtype, device=dev),
            v_tail=torch.zeros(tail, dtype=dtype, device=dev),
            key_ns=f"kvcache{next(_CACHE_IDS)}",
            device_pages=device_pages,
        )

    @property
    def full_pages(self) -> int:
        return self.length // self.page_size

    @property
    def tail_len(self) -> int:
        return self.length % self.page_size

    def pool_stats(self) -> dict:
        return self.pool.snapshot()

    # ------------------------------------------------------------------
    def _store_page(self, page_idx: int, k_page: torch.Tensor,
                    v_page: torch.Tensor) -> None:
        # recent pages rank higher for sparse selection → keep them closest
        kk = f"{self.key_ns}/k{page_idx}"
        vk = f"{self.key_ns}/v{page_idx}"
        self.pool.put(kk, k_page, priority=float(page_idx))
        self.pool.put(vk, v_page, priority=float(page_idx))
        self.k_pool[page_idx] = kk
        self.v_pool[page_idx] = vk
        self.flushes += 1
        # mean key per page (the reference's jnp.mean keeps the input type)
        self.k_summary[page_idx] = k_page.float().mean(dim=1).to(self.dtype)
        if self._kbuf is not None:
            # install at flush: the newest page is the hottest, and taking
            # it from the tail (not a pool fetch-back) keeps the buffer
            # exact whatever the pool does to its copy
            self._install_page(page_idx, k_page, v_page)

    def append(self, k_t: torch.Tensor, v_t: torch.Tensor) -> None:
        """Append one token's K/V: (B, Hkv, D)."""
        i = self.tail_len
        self.k_tail[:, i] = k_t
        self.v_tail[:, i] = v_t
        self.length += 1
        if self.length % self.page_size == 0:
            # Store: commit the full tail page (the pool keeps a copy, so
            # the tail buffer is free to refill in place)
            self._store_page(self.length // self.page_size - 1,
                             self.k_tail, self.v_tail)

    def prefill(self, k_seq: torch.Tensor, v_seq: torch.Tensor) -> None:
        """Bulk-append a prompt: (B, S, Hkv, D)."""
        s = k_seq.shape[1]
        ps = self.page_size
        n_full = s // ps
        for pi in range(n_full):
            self._store_page(pi, k_seq[:, pi * ps:(pi + 1) * ps].to(self.dtype),
                             v_seq[:, pi * ps:(pi + 1) * ps].to(self.dtype))
        rem = s - n_full * ps
        if rem:
            self.k_tail[:, :rem] = k_seq[:, n_full * ps:]
            self.v_tail[:, :rem] = v_seq[:, n_full * ps:]
        self.length = s

    # ------------------------------------------------------------------
    def select_pages(self, q: torch.Tensor, top_k: Optional[int]) -> np.ndarray:
        """Sparse block selection: rank full pages by mean-key relevance to
        the query (B, Hq, D) → sorted page indices (host ints)."""
        n = self.full_pages
        if n == 0:
            return np.zeros((0,), np.int64)
        if top_k is None or top_k >= n:
            return np.arange(n)
        qm = q.float().mean(dim=(0, 1))                          # (D,)
        scores = torch.einsum("nbhd,d->n", self.k_summary[:n].float(), qm)
        idx = torch.topk(scores, top_k).indices.cpu().numpy()
        return np.sort(idx)

    def _page_shape(self) -> Tuple[int, ...]:
        return (self.batch, self.page_size, self.n_kv_heads, self.head_dim)

    def _empty_pages(self) -> torch.Tensor:
        return torch.zeros((0,) + self._page_shape(), dtype=self.dtype,
                           device=self.device)

    def fetch_pages(self, idx: Sequence[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prefetch (sync): copy the selected pool pages to the device.
        Returns (n_sel, B, page, Hkv, D) tensors."""
        if len(idx) == 0:
            return self._empty_pages(), self._empty_pages()
        ks = [self.pool.get(self.k_pool[int(i)]) for i in idx]
        vs = [self.pool.get(self.v_pool[int(i)]) for i in idx]
        self.fetches += len(idx)
        return torch.stack(ks), torch.stack(vs)

    def prefetch_pages(self, idx: Sequence[int]) -> PrefetchedPages:
        """Prefetch (async): issue page fetches through the pool's transfer
        engine; the caller overlaps compute and calls ``.wait()`` at use."""
        idx = np.asarray(idx, np.int64)
        kh = [self.pool.prefetch(self.k_pool[int(i)]) for i in idx]
        vh = [self.pool.prefetch(self.v_pool[int(i)]) for i in idx]
        self.fetches += len(idx)
        return PrefetchedPages(idx=idx, k_handles=kh, v_handles=vh,
                               _empty=self._empty_pages())

    # ------------------------------------------------------------------
    def attend(self, q: torch.Tensor, *, scale: float,
               top_k_pages: Optional[int] = None,
               prefetched=None) -> torch.Tensor:
        """Decode attention of q (B, Hq, D) over selected pages + tail (the
        gather path). ``prefetched`` — a ``PrefetchedPages`` or an
        already-waited (k, v, idx) tuple — lets a caller overlap the
        fetches with other work."""
        if prefetched is not None:
            if isinstance(prefetched, PrefetchedPages):
                kp, vp, _ = prefetched.wait()
            else:
                kp, vp, _ = prefetched
        else:
            kp, vp = self.fetch_pages(self.select_pages(q, top_k_pages))
        return paged_attend_gathered(q, kp, vp, self.k_tail, self.v_tail,
                                     self.tail_len, scale=scale)

    # -- fused decode over the device page buffer ----------------------
    @property
    def n_slots(self) -> int:
        return self.device_pages if self.device_pages is not None \
            else self.n_pages

    def _ensure_buffer(self) -> None:
        if self._kbuf is None:
            shape = (self.n_slots,) + self._page_shape()
            self._kbuf = torch.zeros(shape, dtype=self.dtype,
                                     device=self.device)
            self._vbuf = torch.zeros_like(self._kbuf)
            self._slot_page = [None] * self.n_slots
            self._slot_use = [0] * self.n_slots

    def _touch(self, slot: int) -> None:
        self._use_clock += 1
        self._slot_use[slot] = self._use_clock

    def _alloc_slot(self, keep: frozenset) -> int:
        """A free slot, else the LRU slot whose page is not needed this
        step; its old page stays safe in the pool (the buffer is a cache,
        never the only copy of a flushed page)."""
        victims = [s for s in range(self.n_slots)
                   if self._slot_page[s] is None
                   or self._slot_page[s] not in keep]
        if not victims:
            raise ValueError(
                f"device_pages={self.n_slots} is smaller than one step's "
                "page selection; raise the budget or lower top_k_pages")
        slot = min(victims, key=lambda s: (self._slot_page[s] is not None,
                                           self._slot_use[s]))
        old = self._slot_page[slot]
        if old is not None:
            del self._slot_of[old]
        return slot

    def _install_page(self, page_idx: int, k_page: torch.Tensor,
                      v_page: torch.Tensor,
                      keep: frozenset = frozenset()) -> None:
        slot = self._slot_of.get(page_idx)
        if slot is None:
            slot = self._alloc_slot(keep)
            self._slot_of[page_idx] = slot
            self._slot_page[slot] = page_idx
        self._kbuf[slot] = k_page
        self._vbuf[slot] = v_page
        self._touch(slot)

    def _ensure_resident(self, idx: Sequence[int]) -> List[int]:
        """Map the selected page indices onto buffer slots, fetching misses
        from the pool. Returns the slot table the fused attention walks."""
        self._ensure_buffer()
        need = frozenset(int(i) for i in idx)
        slots = []
        for i in idx:
            i = int(i)
            slot = self._slot_of.get(i)
            if slot is None:
                self.buffer_misses += 1
                self.fetches += 1
                self._install_page(i, self.pool.get(self.k_pool[i]),
                                   self.pool.get(self.v_pool[i]), keep=need)
                slot = self._slot_of[i]
            else:
                self.buffer_hits += 1
                self._touch(slot)
            slots.append(slot)
        return slots

    def attend_fused(self, q: torch.Tensor, *, scale: float,
                     top_k_pages: Optional[int] = None) -> torch.Tensor:
        """Fused decode attention of q (B, Hq, D) over selected pages +
        tail — the same selection and merged-softmax semantics as
        ``attend``, but over the device page buffer through a page table:
        no per-step gather from the pool. On a CUDA device this launches
        the paged-decode kernel (``runtime.use_attention_impl("plain")``
        runs its plain version instead, for comparison); on the CPU the
        plain version is bit for bit the gather path."""
        slots = self._ensure_resident(self.select_pages(q, top_k_pages))
        table = torch.tensor(slots, dtype=torch.int32, device=self.device)
        args = (q, self._kbuf, self._vbuf, table, self.k_tail, self.v_tail,
                self.tail_len)
        if runtime.attention_impl(q.device) == "kernel":
            return paged_decode_attention_cuda(*args, scale=scale)
        return paged_decode_attention_ref(*args, scale=scale)
