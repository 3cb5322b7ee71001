"""Request-level continuous-batching scheduler with plan-driven KV prefetch
(the port's copy of ``repro.sched.scheduler``).

The step loop joins and retires sequences **every decode step**
(continuous batching): a fixed set of ``max_batch`` cache slots holds the
running requests; each step the scheduler

1. admits queued requests — at most ``prefill_budget`` per step — if a
   slot is free AND the pool's admitting tiers can hold the request's
   worst-case pages (``AdmissionController``); admitted prompts are
   prefilled (batch 1) and scattered into their slot, and their first
   token sampled from the prefill logits exactly as
   ``ServeEngine.generate`` does. With an enabled ``SLOConfig`` the best
   ready request (priority class, then earliest TTFT deadline) goes first,
   certainly-infeasible requests are shed, and a deadline-pressed arrival
   may preempt (park) a running lower-priority sequence, which resumes
   when a slot frees;

   with **chunked prefill** (``chunk_size`` set) prompts instead advance
   ``chunk_size`` tokens per scheduler step through ``Model.prefill_chunk``
   at one (1, chunk_size) shape (final partial chunks padded and masked):
   the PREFILL state persists across steps, the per-step budget is
   ``prefill_tokens`` *tokens* (default: one chunk), and the first token is
   sampled when the last chunk lands. Between chunk steps the partial
   batch-1 row cache stays on the request state (resident) or is parked
   page by page through the pool (``kv_offload``), under the ``L{i}.{j}``
   labels the decode loop parks under. With a ``prefix_cache`` an admitted
   prompt's cached leading pages are copied into its row and prefill
   starts after them; a retiring prompt donates its full pages;
2. (``kv_offload``) waits on the fetches the previous step issued, in the
   plan's consumption order — each layer's job copies its pages straight
   into their batch-cache slots — after the admission and prefill work of
   step 1, which the transfers overlap;
3. decodes all running requests in ONE batched ``decode_step`` with
   per-row positions (a (B,) device tensor, sent with the tokens in one
   host-to-device copy; on the card the ring-decode kernel reads it per
   row), reads the step's tokens on the host, and retires requests that
   hit their budget — freeing slots for step 1 of the next iteration. On
   the card the step is captured once as a CUDA graph and replayed
   (``sched.graph.DecodeGraph``), bit for bit the eager step;
4. in ``kv_offload`` mode, parks every running request's pages back into
   the pool (stable per-page keys, priority = remaining decode budget — the
   pool's priority+LRU manager spills *cold* sequences' pages, those
   closest to retirement, to the host tier under device-tier pressure) and
   at once issues the next step's fetches along the planner's refined
   order (``PlanPrefetcher``), one job per layer, each page's destination
   its slot in the batch cache.

The caches are written in place (the reference threads donated arrays).
That is safe because every park stores a copy: a device-tier put copies
the row on the compute stream before the next decode writes it, and a
host-tier put copies on the transfer engine's stream after the compute
stream and returns once the bytes have landed; a fetched page lands in its
slot on the copy stream, and the compute stream waits on the copy before
anything reads or writes the slot again (a preempted row's slot too:
``_preempt`` waits on the landings before the slot is freed). For
the same reason a resident DECODE row that is preempted is copied out of
its slot (the reference keeps a slice, which JAX copies), and prefix pages
donated from the batch cache are views that the pool's put copies.

Requests carry tokens only, as the reference's do: an M-RoPE model
(qwen2-vl) runs text-only, its positions the sequence index in all three
planes, and an encoder model (whisper), whose prefill needs its
frontend's frames, is refused.

Time is a virtual clock (1.0 per step) so arrival traces and latency
measurements are deterministic; wall-clock throughput is the caller's to
measure around ``run``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.costmodel import H100, HardwareSpec
from repro_torch.core.insertion import InsertionOptions
from repro_torch.device import device_of
from repro_torch.models.model import Model
from repro_torch.obs.metrics import STEP_BUCKETS, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.offload.kvcache import KVPageTable, worst_case_page_bytes
from repro_torch.pool import MemoryPoolManager, auto_depth, default_pool
from repro_torch.pool.manager import PoolEntry
from repro_torch.prefix import PrefixCacheManager
from repro_torch.sched.graph import DecodeGraph
from repro_torch.sched.prefetch import InFlightFetches, PlanPrefetcher
from repro_torch.sched.queue import AdmissionController, ArrivalQueue
from repro_torch.sched.requests import (
    DECODE, DONE, PREEMPTED, PREFILL, SHED, Request, RequestState,
)
from repro_torch.serving.engine import (
    _flatten, jit_decode, jit_prefill, jit_prefill_chunk,
)
from repro_torch.serving.sampling import sample_token
from repro_torch.slo.admission import GoodputController
from repro_torch.slo.policy import SLOConfig, candidate_key
from repro_torch.slo.preempt import PreemptionEngine

#: pool priority of a preempted request's parked pages: below every live
#: sequence's pages (priority >= 1, their remaining work) but above the
#: prefix cache's 0.0 — device pressure spills preempted rows first.
_PREEMPTED_PAGE_PRIO = 0.25

_SCHED_IDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_batch: int = 4            # cache slots (concurrent requests)
    max_seq: int = 128            # per-slot cache capacity
    prefill_budget: int = 1       # prompts prefilled (joined) per step
    # chunked prefill: when chunk_size is set, prompts advance chunk_size
    # tokens per scheduler step (final partial chunks padded+masked) and
    # prefill_tokens is the per-step *token* budget across requests (None
    # → one chunk per step). prefill_budget is ignored in chunked mode;
    # None chunk_size keeps the whole-prompt path.
    chunk_size: Optional[int] = None
    prefill_tokens: Optional[int] = None
    kv_offload: bool = False      # pages live in the pool between steps
    cache_dtype: torch.dtype = torch.float32
    hw: HardwareSpec = H100       # cost model driving the prefetch plan
    # planner knobs for the prefetch plan; None → the paged default
    # (PAGED_INSERTION)
    insert_opts: Optional[InsertionOptions] = None
    refine: bool = True
    # SLO-aware scheduling: None (or enable=False) keeps pure FIFO +
    # capacity admission; enabled, ready requests are admitted best-first
    # (priority class, then earliest TTFT deadline), certainly-infeasible
    # requests are shed, and deadline-pressed arrivals may preempt (park) a
    # running lower-priority sequence.
    slo: Optional[SLOConfig] = None


@dataclasses.dataclass
class SchedStats:
    steps: int = 0
    joins: int = 0
    retires: int = 0
    prefill_tokens: int = 0
    prefill_chunks: int = 0       # prefill_chunk calls (chunked mode)
    decoded_tokens: int = 0
    pages_parked: int = 0
    cold_spills: int = 0          # our pages spilled down-tier by the manager
    prefix_hits: int = 0          # admissions that matched the prefix cache
    prefix_hit_tokens: int = 0    # prompt tokens served from cached prefixes
    preemptions: int = 0          # running sequences parked for a deadline
    resumes: int = 0              # preempted sequences restored to a slot
    shed: int = 0                 # requests dropped as deadline-infeasible


@dataclasses.dataclass
class SchedClock:
    """The scheduler's readings of the host clock (``time.perf_counter``),
    beside the virtual steps of ``SchedStats``: requests admitted to a
    slot, and the seconds they waited for it from ``submit()``; and how
    each batched decode ran (``sched.graph.DecodeGraph``): captured as a
    CUDA graph (the step itself run eagerly), replayed, or eager."""

    admissions: int = 0
    queue_wait_s: float = 0.0
    decode_captures: int = 0
    decode_replays: int = 0
    decode_eager: int = 0


class ContinuousScheduler:
    def __init__(self, model: Model, params: Any,
                 cfg: SchedulerConfig = SchedulerConfig(), *,
                 pool: Optional[MemoryPoolManager] = None,
                 plan_cache: Optional[Dict[Any, Any]] = None,
                 prefix_cache: Optional[PrefixCacheManager] = None,
                 tracer=None,
                 metrics: Optional[MetricsRegistry] = None) -> None:
        if model.cfg.encoder is not None:
            # the reference's prefill fails on the missing enc_embeds at
            # the first admission; the port refuses up front
            raise ValueError(
                f"model {model.cfg.name!r} needs its encoder frontend's "
                "inputs (enc_embeds), which the scheduler's text-only "
                "requests do not carry; serve it with ServeEngine")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = device_of(params)
        self._ns = f"sched{next(_SCHED_IDS)}"
        self.stats = SchedStats()
        self.clock = SchedClock()
        #: req_id -> host time of submit(), until the request takes a slot
        self._t_submit: Dict[int, float] = {}
        self.finished: Dict[int, RequestState] = {}
        self._tracer = tracer if tracer is not None else NULL_TRACER
        # per-request latency histograms (virtual scheduler steps)
        self._metrics = metrics
        if metrics is not None:
            self._h_ttft = metrics.histogram(
                "req_ttft_steps", STEP_BUCKETS,
                "request arrival to first token, scheduler steps")
            self._h_queue_wait = metrics.histogram(
                "req_queue_wait_steps", STEP_BUCKETS,
                "request arrival to admission, scheduler steps")
            self._h_tpot = metrics.histogram(
                "req_time_per_output_token_steps",
                (0.25, 0.5, 1, 2, 4, 8, 16, 32),
                "mean per-output-token latency after the first token, "
                "scheduler steps")

        if cfg.chunk_size is not None:
            if not 1 <= cfg.chunk_size <= cfg.max_seq:
                raise ValueError(
                    f"chunk_size {cfg.chunk_size} must be in [1, max_seq="
                    f"{cfg.max_seq}]")
            if not model.supports_chunked_prefill():
                raise ValueError(
                    f"model {model.cfg.name!r} has recurrent or cross-"
                    "attention layers; chunked prefill supports attention/"
                    "MLA self-attention models only (leave chunk_size "
                    "unset for whole-prompt prefill)")
            self._chunk_prefill = jit_prefill_chunk(model)
        if cfg.prefill_tokens is not None:
            if cfg.chunk_size is None:
                raise ValueError("prefill_tokens (a per-step token budget) "
                                 "requires chunk_size")
            if cfg.prefill_tokens < 1:
                raise ValueError("prefill_tokens must be >= 1")
        self._prefill = jit_prefill(model)
        self._decode_graph = DecodeGraph(jit_decode(model), self.clock)
        self._decode = self._decode_graph
        self.cache = model.init_cache(cfg.max_batch, cfg.max_seq,
                                      cfg.cache_dtype, device=self.device)
        self.slots: List[Optional[RequestState]] = [None] * cfg.max_batch
        # flat layer index -> (segment, repeat, pattern position); matches
        # cfg.layer_specs() and the decode-graph layer numbering
        self._flat: List[Tuple[int, int, int]] = [
            (si, ri, pi)
            for si, seg in enumerate(model.cfg.segments)
            for ri in range(seg.repeats)
            for pi in range(len(seg.pattern))
        ]
        self._owns_pool = pool is None
        # one full step's page fetches (every leaf of every slot) must
        # issue before anything waits — the auto depth policy's `pages`
        pages = cfg.max_batch * sum(
            len(_flatten(self._subtree(si, pi))[0]) for si, _, pi in self._flat)
        if pool is None:
            if cfg.kv_offload:
                raise ValueError(
                    "ContinuousScheduler(kv_offload=True) requires a pool "
                    "(construct it through "
                    "repro_torch.api.HyperOffloadSession, or pass "
                    "repro_torch.pool.default_pool())")
            pool = default_pool(device=self.device,
                                transfer_depth=auto_depth(pages=pages))
        elif cfg.kv_offload:
            if pool.device != self.device:
                raise ValueError(f"pool on {pool.device}, parameters on "
                                 f"{self.device}")
            # shared pool: grow the engine to cover this consumer
            pool.transfer.ensure_depth(auto_depth(pages=pages))
        self.pool = pool
        self._plan_cache = plan_cache
        self.queue = ArrivalQueue()
        self.admission = AdmissionController(
            self.pool, itemsize=cfg.cache_dtype.itemsize)
        self._row_bytes = worst_case_page_bytes(
            model.cache_specs(1, cfg.max_seq, cfg.cache_dtype))
        # SLO-aware scheduling: policy objects + the parked (preempted)
        # states, which are in neither the queue nor a slot but still hold
        # their capacity reservation
        self.slo: Optional[SLOConfig] = \
            cfg.slo if (cfg.slo is not None and cfg.slo.enable) else None
        self.preempted: List[RequestState] = []
        self.goodput: Optional[GoodputController] = None
        self.preemptor: Optional[PreemptionEngine] = None
        if self.slo is not None:
            self.goodput = GoodputController(self.slo, metrics=metrics)
            self.preemptor = PreemptionEngine(self.slo)
        self.prefetcher: Optional[PlanPrefetcher] = None
        self._inflight: Optional[InFlightFetches] = None
        if cfg.kv_offload:
            self.prefetcher = PlanPrefetcher(
                model.cfg, cfg.max_batch, cfg.max_seq, pool=self.pool,
                hw=cfg.hw, refine=cfg.refine, insert_opts=cfg.insert_opts,
                plan_cache=plan_cache, tracer=self._tracer)
            self.pool.add_evict_listener(self._on_evict)
        self.prefix_cache = prefix_cache
        if prefix_cache is not None:
            if cfg.chunk_size is None:
                raise ValueError(
                    "prefix_cache requires chunked prefill (chunk_size): a "
                    "hit resumes prefill at the match offset, which only "
                    "the chunked path supports")
            if cfg.kv_offload and prefix_cache.pool is not self.pool:
                raise ValueError(
                    "prefix_cache must share the scheduler's pool in "
                    "kv_offload mode (prefix-page fetches ride the same "
                    "PlanPrefetcher plan)")
            # prefix reuse slices/restores KV by absolute position, which
            # is only exact while no cache leaf's ring buffer has wrapped:
            # requests longer than the shortest leaf (a sliding-window
            # layer's window) bypass the cache entirely
            self._prefix_seq_limit = min(
                int(leaf.shape[2]) for leaf in _flatten(self.cache)[0])
        self.now = 0.0
        self._closed = False

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> RequestState:
        if request.total_len > self.cfg.max_seq:
            raise ValueError(
                f"request {request.req_id}: prompt+decode "
                f"{request.total_len} exceeds max_seq {self.cfg.max_seq}")
        if self._tracer.enabled:
            self._tracer.instant("request", "QUEUED",
                                 {"req": request.req_id,
                                  "prompt_len": request.prompt_len,
                                  "arrival": request.arrival})
        state = self.queue.push(request)
        self._t_submit[request.req_id] = time.perf_counter()
        return state

    @property
    def active(self) -> List[RequestState]:
        return [s for s in self.slots if s is not None]

    def close(self) -> None:
        """Idempotent shutdown: drop remaining pages, unhook from a shared
        pool, close an owned pool."""
        if self._closed:
            return
        self._closed = True
        if self._inflight is not None:
            # the landings write the batch cache: let them finish first
            self._inflight.wait_all()
            self._inflight = None
        if self.cfg.kv_offload:
            self.pool.remove_evict_listener(self._on_evict)
        for st in (list(self.slots) + list(self.preempted)
                   + list(self.finished.values())):
            if st is not None:
                if st.pages is not None:
                    st.pages.drop()
                if st.prefix_hit is not None and self.prefix_cache is not None:
                    self.prefix_cache.release(st.prefix_hit)
                self.admission.release(st)
        self._decode_graph.reset()
        if self._owns_pool:
            self.pool.close()

    def pool_stats(self) -> Dict[str, Any]:
        return self.pool.snapshot()

    def prefetch_stats(self) -> Optional[Dict[str, float]]:
        return None if self.prefetcher is None else \
            self.prefetcher.stats.snapshot()

    def prefix_stats(self) -> Optional[Dict[str, float]]:
        return None if self.prefix_cache is None else \
            self.prefix_cache.snapshot()

    # -- step phases ---------------------------------------------------
    def _on_evict(self, entry: PoolEntry, dst: str) -> None:
        if entry.key.startswith(self._ns + "/"):
            self.stats.cold_spills += 1

    def _subtree(self, si: int, pi: int):
        return self.cache["segments"][si][f"p{pi}"]

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of a small host array. On the card it
        goes through pinned memory without blocking the host (the pinned
        block is not reused before the copy has run)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _collect_inflight(self) -> None:
        """Wait (in the plan's consumption order) on the fetches issued at
        the end of the previous step: their jobs have copied the pages into
        the batch cache in place, and each wait makes the compute stream
        wait on its job's copies."""
        self._inflight.wait_all()
        self._inflight = None

    def _reserve_capacity(self, state: RequestState) -> bool:
        """Worst-case capacity reservation (the request's page-key prefix
        ``covers`` its future parked pages — "-" guards req3 vs req30).
        False = capacity pressure."""
        covers = f"{self._ns}/req{state.req_id}-"
        if self.admission.try_admit(state, self._row_bytes, covers):
            return True
        if (not self.active and not self.preempted
                and not self.admission.can_ever_admit(self._row_bytes)):
            raise RuntimeError(
                f"request {state.req_id} can never be admitted: "
                f"worst-case pages ({self._row_bytes} B) exceed the "
                "pool's device+host capacity")
        return False   # retirements will free it

    def _try_admit_head(self) -> Optional[Tuple[RequestState, int]]:
        """Admission guard shared by both prefill paths: pop the arrival
        queue's best candidate into a free slot (SLO mode: possibly freed
        by preemption) if the pool can hold its worst-case pages. Returns
        (state, slot) or None (no slot / not arrived / capacity
        pressure)."""
        if self.slo is not None:
            return self._try_admit_slo()
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return None
        state = self.queue.head_ready(self.now)
        if state is None:
            return None
        if not self._reserve_capacity(state):
            return None
        self.queue.pop()
        return state, free[0]

    def _try_admit_slo(self) -> Optional[Tuple[RequestState, int]]:
        """SLO admission: the best ready candidate (priority class, then
        earliest TTFT deadline — ``slo.candidate_key``) takes a free slot,
        or — when none is free and its deadline can't survive waiting for
        a natural retirement — a slot freed by preempting a running
        lower-priority sequence. Capacity is reserved *before* the
        preemption is performed, so a reservation failure never parks a
        victim for nothing."""
        ready = self.queue.ready(self.now)
        if not ready:
            return None
        state = min(ready, key=candidate_key)
        free = [i for i, s in enumerate(self.slots) if s is None]
        if free:
            if not self._reserve_capacity(state):
                return None
            self.queue.remove(state)
            return state, free[0]
        running = self.active
        if self.cfg.kv_offload:
            # a sequence that reached DECODE *this step* (prefill just
            # finished) has its freshest row only in the batch cache — its
            # pool pages aren't parked until this step's epilogue — so it
            # is not preemptible yet
            running = [s for s in running
                       if not (s.status == DECODE
                               and s.last_step == self.stats.steps)]
        victim = self.preemptor.pick_victim(
            state, running, self.now,
            est_prefill_steps=self._est_prefill_steps(state),
            remaining_steps=self._remaining_steps)
        if victim is None:
            return None
        if not self._reserve_capacity(state):
            return None
        slot = victim.slot
        self._preempt(victim)
        self.queue.remove(state)
        return state, slot

    # -- SLO mechanics -------------------------------------------------
    def _est_prefill_steps(self, state: RequestState) -> float:
        """Optimistic steps from admission to first token for a queued
        candidate: its remaining prompt plus the prompt backlog already
        mid-prefill, at the measured per-step prefill rate. Whole-prompt
        mode prefills in the admission step itself."""
        if self.cfg.chunk_size is None:
            return 1.0
        base = self.cfg.prefill_tokens or self.cfg.chunk_size
        rate = self.goodput.rate(base)
        backlog = sum(max(s.request.prompt_len - s.prefill_pos, 0)
                      for s in self.slots
                      if s is not None and s.status == PREFILL)
        remaining = max(state.request.prompt_len - state.prefill_pos, 0)
        return max(1.0, np.ceil((backlog + remaining) / rate))

    def _remaining_steps(self, s: RequestState) -> int:
        """Steps until a running state retires and frees its slot (decode
        budget plus, mid-prefill, its outstanding chunks)."""
        n = s.request.max_new_tokens - len(s.out)
        if s.status == PREFILL and self.cfg.chunk_size is not None:
            base = self.cfg.prefill_tokens or self.cfg.chunk_size
            rem = max(s.request.prompt_len - s.prefill_pos, 0)
            n += -(-rem // base)
        return n

    def _slo_shed_sweep(self) -> None:
        """Drop every ready request whose TTFT deadline is certainly
        unmeetable — *before* admission, so no prefill is spent on
        admitted-then-missed work."""
        for state in self.queue.ready(self.now):
            if self.goodput.infeasible(
                    state, self.now, self._est_prefill_steps(state)):
                self._shed(state)

    def _shed(self, state: RequestState) -> None:
        """Terminal drop from the queue: never admitted, so there is no
        slot, reservation, or page to release."""
        self.queue.remove(state)
        self._t_submit.pop(state.req_id, None)
        state.status = SHED
        state.t_done = self.now
        self.finished[state.req_id] = state
        self.stats.shed += 1
        self.goodput.note_retired(state)
        if self._tracer.enabled:
            self._tracer.instant("request", "SHED",
                                 {"req": state.req_id,
                                  "arrival": state.request.arrival})

    def _preempt(self, victim: RequestState) -> None:
        """Park a running sequence and free its slot. A DECODE victim's
        rows are either already pool-resident from the last ``_park_and_
        issue`` (kv_offload — just demote their priority, after waiting on
        the in-flight fetches that land its pages in the slot, so none
        lands on the slot's next occupant: they bring back the victim's
        own parked bytes) or copied out of
        the batch cache onto ``chunk_cache`` (resident: a copy, since the
        next request in the slot writes the batch cache in place). A
        mid-PREFILL victim's partial row is already on ``chunk_cache``/in
        the pool (``_park_chunk_row`` ran when the chunk budget moved on).
        The capacity reservation is kept — the pages still occupy pool
        space, so admission stays exactly as conservative as before."""
        slot = victim.slot
        if victim.status == DECODE and not self.cfg.kv_offload:
            row = self._new_row()
            for big, r in zip(_flatten(self.cache)[0], _flatten(row)[0]):
                r[:, 0] = big[:, slot]
            victim.chunk_cache = row
        if self.cfg.kv_offload and victim.pages is not None:
            if victim.status == DECODE and self._inflight is not None:
                # every planned layer's job carries every live row's pages
                self._inflight.wait_all()
            for key in victim.pages.keys.values():
                self.pool.set_priority(key, _PREEMPTED_PAGE_PRIO)
        victim.status = PREEMPTED
        victim.preemptions += 1
        victim.slot = None
        self.slots[slot] = None
        self.preempted.append(victim)
        self.stats.preemptions += 1
        if self._tracer.enabled:
            self._tracer.instant("request", "PREEMPTED",
                                 {"req": victim.req_id, "slot": slot})

    def _resume_preempted(self, *, final: bool) -> None:
        """Restore preempted sequences into free slots, best first. In the
        pre-pass (``final=False``) a preempted sequence only takes a slot
        if it outranks every ready queued candidate — otherwise admission
        gets first claim on the slot this step; the post-pass
        (``final=True``) hands any slots admission left free back to
        preempted work (its capacity is already reserved)."""
        while self.preempted:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                return
            best = min(self.preempted, key=candidate_key)
            if not final:
                ready = self.queue.ready(self.now)
                if ready and min(candidate_key(s) for s in ready) \
                        < candidate_key(best):
                    return
            # by identity: dataclass equality would compare token arrays
            self.preempted = [s for s in self.preempted if s is not best]
            self._resume(best, free[0])

    def _resume(self, state: RequestState, slot: int) -> None:
        """Inverse of ``_preempt``: a DECODE sequence's row rides the same
        restore path parked mid-prefill chunks use (chunk_cache or plan-
        driven pool fetches) and is scattered back into the slot; a mid-
        PREFILL sequence just re-enters the chunked loop, which restores
        its row on its next advance."""
        was_decode = state.t_first_token is not None
        self.slots[slot] = state
        state.slot = slot
        state.status = DECODE if was_decode else PREFILL
        self.stats.resumes += 1
        if was_decode:
            self._scatter_row(self._restore_chunk_row(state), slot)
        if self._tracer.enabled:
            self._tracer.instant("request", "RESUMED",
                                 {"req": state.req_id, "slot": slot})

    def slo_snapshot(self) -> Optional[Dict[str, int]]:
        return None if self.goodput is None else self.goodput.snapshot()

    def _admit_and_prefill(self) -> List[Tuple[int, int]]:
        if self.slo is not None:
            # SLO pre-pass: reset the preemption quota, shed certainly-
            # infeasible arrivals before any admission work, and restore
            # preempted sequences that outrank everything still queued
            pt0 = self.stats.prefill_tokens
            self.preemptor.begin_step()
            self._slo_shed_sweep()
            self._resume_preempted(final=False)
        if self.cfg.chunk_size is not None:
            emitted = self._admit_and_prefill_chunked()
        else:
            emitted = []
            for _ in range(self.cfg.prefill_budget):
                admitted = self._try_admit_head()
                if admitted is None:
                    break
                emitted.append(self._join(*admitted))
        if self.slo is not None:
            # slots admission left free (no ready candidates / capacity)
            # go back to preempted sequences, and the step's landed
            # prefill tokens feed the measured-rate estimate
            self._resume_preempted(final=True)
            self.goodput.note_step(self.stats.prefill_tokens - pt0)
        return emitted

    def _admit_and_prefill_chunked(self) -> List[Tuple[int, int]]:
        """Chunked admission/prefill: spend up to ``prefill_tokens`` chunk
        tokens this step — first advancing requests already mid-PREFILL
        (oldest join first, so prompts finish in admission order), then
        admitting new ones while budget remains. Each chunk call charges a
        full ``chunk_size`` against the budget (a padded final chunk costs
        the same compute as a full one); the first chunk of a step always
        runs even if the budget is smaller than one chunk, so the loop
        can't stall."""
        emitted: List[Tuple[int, int]] = []
        budget = self.cfg.prefill_tokens or self.cfg.chunk_size
        mid = [s for s in self.slots
               if s is not None and s.status == PREFILL]
        if self.goodput is not None:
            # deadline pressure on mid-prefill requests may raise the
            # step's token budget (capped at max_prefill_boost)
            budget = self.goodput.boost_budget(budget, mid, self.now)
        spent = 0
        for s in sorted(mid, key=lambda s: (s.joined_step, s.req_id)):
            out, spent = self._advance_chunks(s, spent, budget)
            emitted += out
        # SLO mode: mid-prefill work exhausting the budget must not hide
        # the admission (and preemption) check from a deadline-pressed
        # arrival — it still gets one seat attempt; its own chunks then
        # start next step
        tries = 0
        while spent < budget or (self.slo is not None and tries == 0):
            tries += 1
            admitted = self._try_admit_head()
            if admitted is None:
                break
            state, slot = admitted
            self._join_chunked(state, slot)
            out, spent = self._advance_chunks(state, spent, budget)
            emitted += out
        return emitted

    def _advance_chunks(self, state: RequestState, spent: int,
                        budget: int) -> Tuple[List[Tuple[int, int]], int]:
        """Advance one request as far as the step's token budget allows,
        holding its row cache across consecutive chunks — the row parks
        (once) only when the budget moves on with the prompt unfinished."""
        emitted: List[Tuple[int, int]] = []
        row = None
        while state.status == PREFILL and spent < budget:
            if row is None:
                row = self._restore_chunk_row(state)
            out, row = self._prefill_chunk_step(state, row)
            emitted += out
            spent += self.cfg.chunk_size
        if row is not None:
            self._park_chunk_row(state, row)
        return emitted, spent

    def _new_row(self) -> Dict:
        return self.model.init_cache(1, self.cfg.max_seq, self.cfg.cache_dtype,
                                     device=self.device)

    def _join_chunked(self, state: RequestState, slot: int) -> None:
        """Take the slot and the capacity reservation; prefill advances in
        ``_prefill_chunk_step`` calls from here on. With a prefix cache, a
        hit pre-loads the shared pages and moves ``prefill_pos`` past
        them — only the uncached suffix is ever prefilled."""
        self._take_slot(state, slot)
        state.prefill_pos = 0
        state.chunk_cache = self._new_row()
        if self.prefix_cache is not None:
            self._apply_prefix_hit(state)

    def _apply_prefix_hit(self, state: RequestState) -> None:
        """Admission-side prefix hit: match the prompt, *copy* every shared
        page into the request's own row cache (the copy is what makes the
        sharing copy-on-write — the cached entries are never written
        again), and resume prefill at the match offset. The match is capped
        at ``prompt_len - 1`` so at least one real token remains to prefill
        (the first sampled token needs its logits). Read refs on the
        matched pages are held until retirement."""
        req = state.request
        if req.total_len > self._prefix_seq_limit:
            return   # a ring-buffer leaf would wrap — positions unreliable
        hit = self.prefix_cache.lookup(req.tokens,
                                       max_tokens=req.prompt_len - 1)
        if hit is None:
            return
        state.prefix_hit = hit
        pages = hit.page_keys()
        values = self._fetch_prefix_pages(pages)
        ps = self.prefix_cache.page_size
        row = state.chunk_cache
        for i, (si, ri, pi) in enumerate(self._flat):
            leaves = _flatten(row["segments"][si][f"p{pi}"])[0]
            for j, leaf in enumerate(leaves):
                for p, entries in enumerate(pages):
                    leaf[ri, 0, p * ps:(p + 1) * ps] = \
                        values[entries[f"L{i}.{j}"]]
        state.prefill_pos = hit.tokens
        self.stats.prefix_hits += 1
        self.stats.prefix_hit_tokens += hit.tokens

    def _fetch_prefix_pages(
            self, pages: List[Dict[str, str]]) -> Dict[str, torch.Tensor]:
        """The matched pages' tensors, on the scheduler's device. Host- or
        remote-resident hits ride the ``PlanPrefetcher`` plan (kv_offload
        mode): every page's fetch issues in the refined order before any is
        waited on, and each wait makes the compute stream wait on its copy.
        Pages the plan doesn't cover — and all pages in resident mode —
        take a pool get, which copies on the compute stream."""
        keys_by_layer: Dict[int, List[str]] = {}
        all_keys: List[str] = []
        for entries in pages:
            for label, key in entries.items():
                layer = int(label[1:label.index(".")])
                keys_by_layer.setdefault(layer, []).append(key)
                all_keys.append(key)
        fetched: Dict[str, torch.Tensor] = {}
        if self.prefetcher is not None:
            fetched = self.prefetcher.issue(keys_by_layer).wait_all()
        pool = self.prefix_cache.pool
        return {k: fetched[k] if k in fetched else pool.get(k)
                for k in all_keys}

    def _prefill_chunk_step(
            self, state: RequestState,
            row: Any) -> Tuple[List[Tuple[int, int]], Optional[Any]]:
        """Advance one request by one chunk against its row cache. Returns
        (emitted, row): the advanced row while the prompt is unfinished
        (the caller keeps it or parks it), or None once the final chunk
        lands — then the row is scattered into the batch slot and the first
        token sampled from the last valid token's logits, exactly as the
        whole-prompt ``_join`` does."""
        req = state.request
        chunk = self.cfg.chunk_size
        start = state.prefill_pos
        end = min(start + chunk, req.prompt_len)
        valid = end - start
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :valid] = req.tokens[start:end]
        logits, row = self._chunk_prefill(
            self.params, {"tokens": self._to_device(toks)}, start, valid, row)
        state.prefill_pos = end
        state.last_step = self.stats.steps
        self.stats.prefill_tokens += valid
        self.stats.prefill_chunks += 1
        if end < req.prompt_len:
            return [], row
        # last chunk landed — shared completion with the whole-prompt path
        state.chunk_cache = None
        return [self._finish_prefill(state, logits, row)], None

    def _park_chunk_row(self, state: RequestState, row: Any) -> None:
        """Between chunk steps the partial row cache stays on the state
        (resident) or is parked page by page through the pool (kv_offload)
        — the ``L{i}.{j}`` labels the decode loop parks under, so once
        decoding starts the entries are replaced in place. Priority =
        remaining work (all decode steps plus unprefilled prompt tokens):
        mid-prefill rows are the hottest pages in the pool."""
        if not self.cfg.kv_offload:
            state.chunk_cache = row
            return
        prio = float(state.request.max_new_tokens
                     + state.request.prompt_len - state.prefill_pos)
        with self._tracer.span("sched", "park_row", req=state.req_id):
            for i, (si, ri, pi) in enumerate(self._flat):
                leaves = _flatten(row["segments"][si][f"p{pi}"])[0]
                for j, leaf in enumerate(leaves):
                    state.pages.park(f"L{i}.{j}", leaf[ri, 0],
                                     self.pool.top_tier, priority=prio)
                    self.stats.pages_parked += 1
        state.chunk_cache = None

    def _restore_chunk_row(self, state: RequestState) -> Any:
        """Inverse of ``_park_chunk_row``: the resident row is handed back
        directly; a parked row rides the ``PlanPrefetcher`` plan — every
        page's fetch issues in the refined order before any is waited on,
        the path decode pages take."""
        if state.chunk_cache is not None:
            row, state.chunk_cache = state.chunk_cache, None
            return row
        with self._tracer.span("sched", "restore_row", req=state.req_id):
            return self._restore_parked_row(state)

    def _restore_parked_row(self, state: RequestState) -> Any:
        row = self._new_row()
        keys_by_layer: Dict[int, List[str]] = {}
        for i, (si, ri, pi) in enumerate(self._flat):
            n = len(_flatten(row["segments"][si][f"p{pi}"])[0])
            keys_by_layer.setdefault(i, []).extend(
                state.pages.key_of(f"L{i}.{j}") for j in range(n))
        fetched: Dict[str, Any] = {}
        if self.prefetcher is not None:
            fetched = self.prefetcher.issue(keys_by_layer).wait_all()
        for i, (si, ri, pi) in enumerate(self._flat):
            leaves = _flatten(row["segments"][si][f"p{pi}"])[0]
            for j, leaf in enumerate(leaves):
                # layers outside the plan fall back to a sync fetch
                val = fetched.get(state.pages.key_of(f"L{i}.{j}"))
                if val is None:
                    val = state.pages.fetch(f"L{i}.{j}")
                leaf[ri, 0] = val
        return row

    def _scatter_row(self, row: Any, slot: int) -> None:
        """Write a batch-1 row cache into the batch cache's ``slot``."""
        for big, r in zip(_flatten(self.cache)[0], _flatten(row)[0]):
            big[:, slot] = r[:, 0]

    def _take_slot(self, state: RequestState, slot: int) -> None:
        """Join bookkeeping shared by both prefill paths: occupy the batch
        slot and (kv_offload) create the request's page table."""
        state.status = PREFILL
        state.slot = slot
        self.slots[slot] = state
        state.joined_step = self.stats.steps
        state.t_joined = self.now
        t_submit = self._t_submit.pop(state.req_id, None)
        if t_submit is not None:
            self.clock.admissions += 1
            self.clock.queue_wait_s += time.perf_counter() - t_submit
        if self.cfg.kv_offload:   # resident mode never parks a page
            state.pages = KVPageTable(
                self.pool, f"{self._ns}/req{state.req_id}")
        self.stats.joins += 1
        if self._tracer.enabled:
            self._tracer.instant("request", "PREFILL",
                                 {"req": state.req_id, "slot": slot})

    def _finish_prefill(self, state: RequestState, logits: torch.Tensor,
                        row: Any) -> Tuple[int, int]:
        """Prompt fully prefilled (whole prompt, or the final chunk):
        scatter the batch-1 row into the slot and sample the first token
        from the last prompt token's logits, as ``ServeEngine.generate``
        does — one implementation for both prefill paths."""
        req = state.request
        self._scatter_row(row, state.slot)
        gen = state.generator(self.device) if req.temperature > 0.0 else None
        tok = int(sample_token(logits[:, 0], gen,
                               temperature=req.temperature,
                               top_k=req.top_k)[0])
        state.out.append(tok)
        state.last_tok = tok
        state.pos = req.prompt_len    # next decode writes here
        state.t_first_token = self.now
        state.status = DECODE
        state.last_step = self.stats.steps
        if self._tracer.enabled:
            self._tracer.instant("request", "DECODE", {"req": req.req_id})
        if state.done:                # max_new_tokens == 1
            self._retire(state)
        return (req.req_id, tok)

    def _join(self, state: RequestState, slot: int) -> Tuple[int, int]:
        req = state.request
        self._take_slot(state, slot)
        logits, row = self._prefill(
            self.params, {"tokens": self._to_device(req.tokens[None, :])},
            self._new_row())
        self.stats.prefill_tokens += req.prompt_len
        return self._finish_prefill(state, logits, row)

    def _decode_active(self) -> List[Tuple[int, int]]:
        live = [s for s in self.slots if s is not None and s.status == DECODE]
        if not live:
            return []
        b = self.cfg.max_batch
        # row 0: the tokens fed, row 1: the per-row positions; a free slot
        # decodes token 0 at pos 0 into its own (unused) row
        feed = np.zeros((2, b), np.int32)
        for s in live:
            feed[0, s.slot] = s.last_tok
            feed[1, s.slot] = s.pos
        dev = self._to_device(feed)
        logits, self.cache = self._decode(self.params, self.cache,
                                          dev[0][:, None], dev[1])
        emitted: List[Tuple[int, int]] = []
        greedy = None   # one batched argmax serves every temperature-0 row
        for s in live:
            req = s.request
            if req.temperature <= 0.0:
                if greedy is None:
                    greedy = sample_token(logits[:, 0]).cpu().numpy()
                t = int(greedy[s.slot])
            else:
                t = int(sample_token(logits[s.slot:s.slot + 1, 0],
                                     s.generator(self.device),
                                     temperature=req.temperature,
                                     top_k=req.top_k)[0])
            s.out.append(t)
            s.last_tok = t
            s.pos += 1
            s.last_step = self.stats.steps
            self.stats.decoded_tokens += 1
            emitted.append((req.req_id, t))
            if s.done:
                self._retire(s)
        return emitted

    def _retire(self, state: RequestState) -> None:
        state.status = DONE
        state.t_done = self.now
        arrival = state.request.arrival
        if self._metrics is not None:
            self._h_ttft.observe(state.t_first_token - arrival)
            self._h_queue_wait.observe(state.t_joined - arrival)
            self._h_tpot.observe((state.t_done - state.t_first_token)
                                 / max(len(state.out) - 1, 1))
        if self._tracer.enabled:
            self._tracer.instant("request", "DONE",
                                 {"req": state.req_id,
                                  "tokens": len(state.out),
                                  "ttft_steps": state.t_first_token - arrival,
                                  "latency_steps": state.t_done - arrival})
        if self.prefix_cache is not None:
            self._donate_prefix(state)
            if state.prefix_hit is not None:
                self.prefix_cache.release(state.prefix_hit)
        if state.pages is not None:
            state.pages.drop()
        self.admission.release(state)
        self.slots[state.slot] = None
        state.slot = None
        self.finished[state.req_id] = state
        self.stats.retires += 1
        if self.goodput is not None:
            self.goodput.note_retired(state)

    def _donate_prefix(self, state: RequestState) -> None:
        """Retirement-side donation: the retired prompt's full prefix pages
        enter the cache instead of being freed. The batch cache still holds
        this slot's rows (retire runs right after the decode or final-chunk
        scatter), so pages are sliced straight out of it — decode only ever
        writes at positions >= prompt_len, so prompt-range slices are
        exactly the prefill-time KV. ``extract`` is lazy (the manager calls
        it only for pages not already cached) and returns views of the
        batch cache, which the pool's put copies before anything writes
        the slot again."""
        req = state.request
        if req.total_len > self._prefix_seq_limit:
            return
        n_pages = req.prompt_len // self.prefix_cache.page_size
        if n_pages < 1:
            return
        slot, ps = state.slot, self.prefix_cache.page_size

        def extract(p: int) -> Dict[str, torch.Tensor]:
            a, b = p * ps, (p + 1) * ps
            page: Dict[str, torch.Tensor] = {}
            for i, (si, ri, pi) in enumerate(self._flat):
                leaves = _flatten(self._subtree(si, pi))[0]
                for j, leaf in enumerate(leaves):
                    page[f"L{i}.{j}"] = leaf[ri, slot, a:b]
            return page

        self.prefix_cache.donate(req.tokens, n_pages, extract)

    def _park_and_issue(self) -> None:
        """kv_offload epilogue: park every running request's pages (stable
        keys), then issue the next step's fetches along the plan.

        Page priority = the request's remaining decode budget: every
        device-resident page saves one host fetch per remaining step, so
        the manager's priority+LRU eviction spills the *coldest* sequences
        — those with the least future work, closest to retirement — first
        under device-tier pressure."""
        live = [s for s in self.slots if s is not None and s.status == DECODE]
        keys_by_layer: Dict[int, List[str]] = {}
        dests_by_layer: Dict[int, List[torch.Tensor]] = {}
        for s in live:
            prio = float(s.request.max_new_tokens - len(s.out))
            for i, (si, ri, pi) in enumerate(self._flat):
                leaves = _flatten(self._subtree(si, pi))[0]
                for j, leaf in enumerate(leaves):
                    slot = leaf[ri, s.slot]
                    key = s.pages.park(f"L{i}.{j}", slot,
                                       self.pool.top_tier, priority=prio)
                    keys_by_layer.setdefault(i, []).append(key)
                    dests_by_layer.setdefault(i, []).append(slot)
                    self.stats.pages_parked += 1
        if keys_by_layer:
            self._inflight = self.prefetcher.issue(keys_by_layer,
                                                   dests_by_layer)

    # ------------------------------------------------------------------
    def replan(self, hw: HardwareSpec) -> None:
        """Swap in a prefetch plan computed under ``hw`` (measured per-tier
        rates, for example). No-op in resident mode (nothing is planned).
        Safe at a step boundary: parked pages keep their keys; only the
        order future fetches issue in (and the plan cached under the new
        spec's name) changes. Counters carry over."""
        self.cfg = dataclasses.replace(self.cfg, hw=hw)
        if self.prefetcher is None:
            return
        old_stats = self.prefetcher.stats
        self.prefetcher = PlanPrefetcher(
            self.model.cfg, self.cfg.max_batch, self.cfg.max_seq,
            pool=self.pool, hw=hw, refine=self.cfg.refine,
            insert_opts=self.cfg.insert_opts, plan_cache=self._plan_cache,
            tracer=self._tracer)
        self.prefetcher.stats.steps = old_stats.steps
        self.prefetcher.stats.fetches_issued = old_stats.fetches_issued

    def step(self) -> List[Tuple[int, int]]:
        """One scheduler step. Returns the (req_id, token) pairs emitted.

        Admission + prefill run *before* the in-flight fetches are waited
        on: that work sits between the previous step's issue and this
        step's wait, so the transfers it overlaps are real. A newly
        admitted slot was free when the fetches were issued (or freed by a
        preemption that waited on its landings), so no landing writes the
        joiner's freshly scattered rows."""
        tr = self._tracer
        with tr.span("sched", "step", step=self.stats.steps):
            with tr.span("sched", "admit_prefill"):
                emitted = self._admit_and_prefill()
            if self._inflight is not None:
                with tr.span("sched", "collect"):
                    self._collect_inflight()
            with tr.span("sched", "decode"):
                emitted += self._decode_active()
            if self.cfg.kv_offload:
                with tr.span("sched", "park_issue"):
                    self._park_and_issue()
        self.stats.steps += 1
        self.now += 1.0
        return emitted

    def default_max_steps(self) -> int:
        """No-progress bound over everything queued + running: per request
        its decode budget, plus every prefill chunk still outstanding.
        Shared by ``run`` and external drivers so the formula cannot
        drift."""
        def _steps_for(s: RequestState) -> int:
            n = s.request.max_new_tokens + 1
            if self.cfg.chunk_size is not None:
                rem = max(s.request.prompt_len - s.prefill_pos, 0)
                n += -(-rem // self.cfg.chunk_size)   # ceil
            return n
        return 16 + 2 * sum(
            _steps_for(s) for s in (list(self.queue.pending()) + self.active
                                    + list(self.preempted)))

    def run(self, requests: Sequence[Request] = (), *,
            max_steps: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Drive the loop until every submitted request completes. Returns
        req_id -> generated token ids."""
        for r in requests:
            self.submit(r)
        if max_steps is None:
            max_steps = self.default_max_steps()
        steps = 0
        while len(self.queue) or self.active or self.preempted:
            if (not self.active and not self.preempted
                    and self.queue.head_ready(self.now) is None):
                self.now = max(self.now, self.queue.next_arrival())  # idle skip
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("scheduler made no progress "
                                   f"({steps} steps, {len(self.queue)} queued)")
        return {rid: st.tokens_array() for rid, st in self.finished.items()}
