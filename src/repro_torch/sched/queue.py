"""Arrival queue and pool-capacity-aware admission control (the port's
copy of ``repro.sched.queue``; ``poisson_trace`` draws from numpy, so a
seeded trace is byte-identical across the two packages).

Admission follows the SLO-offloading systems of the paper's related work
(Select-N, Harvest): a request joins the running batch only if the pool's
**admitting tiers** (declared per-``TierSpec`` in the topology; device +
host in the default chain) can hold its worst-case KV pages *on top of*
current occupancy and every already-admitted request's standing
reservation (``MemoryPoolManager.reserve``). Otherwise it stays QUEUED —
the scheduler never over-commits, so page parks can always be honored
without touching the slow non-admitting tiers.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.pool import DEVICE_TIER, HOST_TIER
from repro_torch.pool.manager import MemoryPoolManager
from repro_torch.sched.requests import Request, RequestState
from repro_torch.slo.policy import SLOSpec

#: the default chain's admitting tiers — kept for callers that pin the
#: historical pair explicitly; ``AdmissionController`` now defaults to the
#: pool topology's own ``admit`` declarations
ADMISSION_TIERS = (DEVICE_TIER, HOST_TIER)


class ArrivalQueue:
    """Pending requests ordered by (arrival time, request id) — FIFO among
    same-time arrivals regardless of submission order, so a future-dated
    head never shadows an already-arrived later submission."""

    def __init__(self, requests: Sequence[Request] = ()) -> None:
        self._q: List[RequestState] = []
        for r in requests:
            self.push(r)

    def push(self, request: Request) -> RequestState:
        """O(log n) search + O(n) insert (``bisect.insort``) instead of
        re-sorting the whole queue per submit — submitting a trace of n
        requests is O(n^2) worst case, not O(n^2 log n) with a full sort's
        constant factors on every push."""
        state = RequestState(request=request)
        bisect.insort(self._q, state,
                      key=lambda s: (s.request.arrival, s.req_id))
        return state

    def __len__(self) -> int:
        return len(self._q)

    def pending(self) -> Tuple[RequestState, ...]:
        """Snapshot of the queued states in arrival order — the public
        read the scheduler's progress bound uses (callers must not reach
        into the private list)."""
        return tuple(self._q)

    def head_ready(self, now: float) -> Optional[RequestState]:
        """The next request whose arrival time has passed (FIFO), without
        removing it."""
        if self._q and self._q[0].request.arrival <= now:
            return self._q[0]
        return None

    def ready(self, now: float) -> Tuple[RequestState, ...]:
        """Every request whose arrival time has passed, in arrival order —
        the SLO-aware scheduler re-ranks these by priority/deadline
        instead of taking the FIFO head."""
        i = bisect.bisect_right(self._q, now,
                                key=lambda s: s.request.arrival)
        return tuple(self._q[:i])

    def pop(self) -> RequestState:
        return self._q.pop(0)

    def remove(self, state: RequestState) -> None:
        """Remove a specific queued state (SLO admission takes the best
        candidate, not necessarily the head; shedding drops mid-queue).
        Matched by identity — dataclass equality would compare token
        arrays elementwise."""
        for i, s in enumerate(self._q):
            if s is state:
                del self._q[i]
                return
        raise ValueError(f"req {state.req_id} not queued")

    def next_arrival(self) -> Optional[float]:
        return self._q[0].request.arrival if self._q else None


class AdmissionController:
    """Reserves worst-case page capacity in the pool per admitted request;
    releases it at retirement. ``blocked`` counts admission refusals (the
    benchmark's queueing-pressure signal)."""

    def __init__(self, pool: MemoryPoolManager,
                 tiers: Optional[Sequence[str]] = None,
                 itemsize: Optional[int] = None) -> None:
        self.pool = pool
        self.tiers = (tuple(tiers) if tiers is not None
                      else pool.admission_tiers)
        # decoded element size of the pages this controller reserves for:
        # the pool counts each tier at decoded-equivalent capacity
        # (``MemoryPoolManager.tier_scale``; 1.0 on every tier of the port,
        # which encodes no page)
        self.itemsize = itemsize
        self.blocked = 0

    def try_admit(self, state: RequestState, nbytes: int,
                  covers: Optional[str] = None) -> bool:
        """``covers``: the request's page-key prefix — its parked pages are
        charged via the reservation, not double-counted as occupancy."""
        key = f"admit/req{state.req_id}"
        if self.pool.reserve(key, nbytes, self.tiers, covers=covers,
                             itemsize=self.itemsize):
            state.reserve_key = key
            return True
        self.blocked += 1
        return False

    def release(self, state: RequestState) -> None:
        if state.reserve_key:
            self.pool.release(state.reserve_key)
            state.reserve_key = ""

    def can_ever_admit(self, nbytes: int) -> bool:
        """Would the request fit in an *empty* pool — i.e. within the
        tiers' decoded-equivalent capacities? (deadlock guard)"""
        cap = 0.0
        for t in self.tiers:
            tier_cap = self.pool.occupancy(t)[1]
            if tier_cap is None:
                return True
            cap += tier_cap / self.pool.tier_scale(t, self.itemsize)
        return nbytes <= int(cap)


#: default specs for poisson_trace's mixed interactive/batch mode: tight
#: first-token deadline on the interactive class, pure-throughput batch
DEFAULT_INTERACTIVE_SLO = SLOSpec("interactive", ttft_deadline=8.0)
DEFAULT_BATCH_SLO = SLOSpec("batch")


def poisson_trace(n_requests: int, *, rate: float, vocab_size: int,
                  prompt_lens: Sequence[int] = (4, 24),
                  new_tokens: Sequence[int] = (2, 16),
                  prompt_quantum: int = 1,
                  long_prompt_lens: Optional[Sequence[int]] = None,
                  long_fraction: float = 0.0,
                  n_prefix_families: Optional[int] = None,
                  prefix_len: int = 0,
                  interactive_fraction: Optional[float] = None,
                  interactive_slo: Optional[SLOSpec] = None,
                  batch_slo: Optional[SLOSpec] = None,
                  seed: int = 0) -> List[Request]:
    """Deterministic mixed-length Poisson arrival trace (benchmarks/tests):
    exponential inter-arrival gaps at ``rate`` requests per unit of
    scheduler time, uniform prompt/decode lengths in the given ranges.

    ``prompt_quantum`` rounds every sampled prompt length **up** onto the
    quantum grid, clamped to the grid point at or below ``hi`` so a
    rounded length never exceeds an off-grid upper bound (a caller sizing
    ``hi`` against ``max_seq`` must not receive longer prompts than asked
    for): emitted lengths are multiples of ``prompt_quantum`` in
    ``[ceil(lo/q)*q, floor(hi/q)*q]``. A quantum larger than a range's
    upper bound has no on-grid length to emit and raises. (Rounding *down*
    with a ``max(lo, …)`` clamp — the old behavior — emitted the off-grid
    ``lo`` whenever ``lo`` was not a multiple, silently growing the set of
    prefill shapes bucketed serving has to compile.)

    ``long_prompt_lens`` + ``long_fraction`` mix a heavy tail of long
    prompts into the trace (same quantum grid): each request draws its
    length from ``long_prompt_lens`` with probability ``long_fraction`` —
    the stall-inducing traffic the chunked-prefill benchmark measures
    p99 step latency under. When ``long_prompt_lens`` is None the RNG
    call sequence is unchanged, so existing seeded traces stay
    byte-identical.

    ``n_prefix_families`` + ``prefix_len`` switch on **shared-prefix
    mode** (the prefix-cache benchmark's traffic shape): ``prefix_len``
    tokens are drawn once per family, and each request's prompt is one
    family's shared prefix followed by its own per-request suffix of the
    usual ``prompt_lens``-sampled length (total prompt = ``prefix_len`` +
    suffix — callers size ``max_seq`` accordingly). The family is drawn
    uniformly per request. When ``n_prefix_families`` is None the RNG call
    sequence is unchanged — seeded traces stay byte-identical.

    ``interactive_fraction`` switches on **mixed interactive/batch
    traffic** (the SLO-scheduling benchmark's shape): each request is
    annotated ``interactive_slo`` with that probability, else
    ``batch_slo`` (defaults: an ``interactive``-class spec with a tight
    TTFT deadline vs a deadline-free ``batch``-class spec). Class draws
    come from a *dedicated* RNG stream derived from ``seed``, so
    annotating a trace never perturbs its traffic: the arrivals, lengths
    and tokens of a seeded trace are byte-identical with the feature on,
    off, or before it existed — an SLO run and a FIFO baseline can share
    literally the same traffic."""
    if interactive_fraction is not None:
        if not 0.0 <= interactive_fraction <= 1.0:
            raise ValueError("interactive_fraction must be in [0, 1]")
        if interactive_slo is None:
            interactive_slo = DEFAULT_INTERACTIVE_SLO
        if batch_slo is None:
            batch_slo = DEFAULT_BATCH_SLO
    if n_prefix_families is not None:
        if n_prefix_families < 1:
            raise ValueError("n_prefix_families must be >= 1")
        if prefix_len < 1:
            raise ValueError("shared-prefix mode needs prefix_len >= 1")
    q = prompt_quantum
    for rng_name, rng_range in (("prompt_lens", prompt_lens),
                                ("long_prompt_lens", long_prompt_lens)):
        if rng_range is not None and (rng_range[1] // q) * q < rng_range[0]:
            raise ValueError(
                f"prompt_quantum {q} has no multiple inside {rng_name} "
                f"range {tuple(rng_range)}: no on-grid length can be "
                "emitted without violating a bound")
    rng = np.random.default_rng(seed)
    # separate stream for class annotation so it consumes none of the
    # traffic stream's draws (see docstring)
    cls_rng = (np.random.default_rng([seed, 0x510])
               if interactive_fraction is not None else None)
    prefixes = None
    if n_prefix_families is not None:
        prefixes = [rng.integers(0, vocab_size, size=prefix_len,
                                 dtype=np.int32)
                    for _ in range(n_prefix_families)]
    t = 0.0
    out: List[Request] = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        lo, hi = prompt_lens
        if long_prompt_lens is not None and rng.random() < long_fraction:
            lo, hi = long_prompt_lens
        s = int(rng.integers(lo, hi + 1))
        # round UP onto the quantum grid, but never past hi's grid floor
        s = min(-(-s // q) * q, (hi // q) * q)
        m = int(rng.integers(new_tokens[0], new_tokens[1] + 1))
        toks = rng.integers(0, vocab_size, size=s, dtype=np.int32)
        if prefixes is not None:
            fam = int(rng.integers(0, n_prefix_families))
            toks = np.concatenate([prefixes[fam], toks])
        slo = None
        if cls_rng is not None:
            slo = (interactive_slo
                   if cls_rng.random() < interactive_fraction
                   else batch_slo)
        out.append(Request(tokens=toks, max_new_tokens=m, arrival=t,
                           seed=i, slo=slo))
    return out
