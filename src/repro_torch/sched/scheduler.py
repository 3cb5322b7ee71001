"""Request-level continuous-batching scheduler with plan-driven KV prefetch
(the port's copy of ``repro.sched.scheduler``, FIFO admission).

The step loop joins and retires sequences **every decode step**
(continuous batching): a fixed set of ``max_batch`` cache slots holds the
running requests; each step the scheduler

1. admits queued requests — at most ``prefill_budget`` per step — if a
   slot is free AND the pool's admitting tiers can hold the request's
   worst-case pages (``AdmissionController``); admitted prompts are
   prefilled (batch 1) and scattered into their slot, and their first
   token sampled from the prefill logits exactly as
   ``ServeEngine.generate`` does;

   with **chunked prefill** (``chunk_size`` set) prompts instead advance
   ``chunk_size`` tokens per scheduler step through ``Model.prefill_chunk``
   at one (1, chunk_size) shape (final partial chunks padded and masked):
   the PREFILL state persists across steps, the per-step budget is
   ``prefill_tokens`` *tokens* (default: one chunk), and the first token is
   sampled when the last chunk lands. Between chunk steps the partial
   batch-1 row cache stays on the request state (resident) or is parked
   page by page through the pool (``kv_offload``), under the ``L{i}.{j}``
   labels the decode loop parks under;
2. (``kv_offload``) waits on the fetches the previous step issued, in the
   plan's consumption order, and scatters the pages into the batch cache —
   after the admission and prefill work of step 1, which the transfers
   overlap;
3. decodes all running requests in ONE batched ``decode_step`` with
   per-row positions (a (B,) device tensor, sent with the tokens in one
   host-to-device copy; on the card the ring-decode kernel reads it per
   row), reads the step's tokens on the host, and retires requests that
   hit their budget — freeing slots for step 1 of the next iteration;
4. in ``kv_offload`` mode, parks every running request's pages back into
   the pool (stable per-page keys, priority = remaining decode budget — the
   pool's priority+LRU manager spills *cold* sequences' pages, those
   closest to retirement, to the host tier under device-tier pressure) and
   at once issues the next step's fetches along the planner's refined
   order (``PlanPrefetcher``).

The caches are written in place (the reference threads donated arrays).
That is safe because every park stores a copy: a device-tier put copies
the row on the compute stream before the next decode writes it, and a
host-tier put copies on the transfer engine's stream after the compute
stream and returns once the bytes have landed; a fetched page reaches the
cache only after the compute stream has waited on its copy's event.

Time is a virtual clock (1.0 per step) so arrival traces and latency
measurements are deterministic; wall-clock throughput is the caller's to
measure around ``run``.

Not ported yet: SLO-aware admission and preemption (``slo.admission``,
``slo.preempt``) and the prefix cache (``prefix``); the constructor
refuses an enabled ``SLOConfig`` and a ``prefix_cache``.
"""

from __future__ import annotations

import dataclasses
import itertools
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
from repro_torch.sched.prefetch import InFlightFetches, PlanPrefetcher
from repro_torch.sched.queue import AdmissionController, ArrivalQueue
from repro_torch.sched.requests import (
    DECODE, DONE, PREFILL, Request, RequestState,
)
from repro_torch.serving.engine import (
    _flatten, jit_decode, jit_prefill, jit_prefill_chunk,
)
from repro_torch.serving.sampling import sample_token
from repro_torch.slo.policy import SLOConfig

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
    # SLO-aware scheduling: None (or enable=False) is FIFO + capacity
    # admission, the only mode of this port so far
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


class ContinuousScheduler:
    def __init__(self, model: Model, params: Any,
                 cfg: SchedulerConfig = SchedulerConfig(), *,
                 pool: Optional[MemoryPoolManager] = None,
                 plan_cache: Optional[Dict[Any, Any]] = None,
                 prefix_cache: Any = None,
                 tracer=None,
                 metrics: Optional[MetricsRegistry] = None) -> None:
        if cfg.slo is not None and cfg.slo.enable:
            raise ValueError(
                "SLO-aware scheduling needs the goodput controller and the "
                "preemption engine (slo/admission.py, slo/preempt.py), "
                "which the port does not have yet; leave SchedulerConfig."
                "slo unset for FIFO admission")
        if prefix_cache is not None:
            raise ValueError(
                "the prefix cache (repro_torch.prefix: prefix/index.py, "
                "prefix/cache.py) is not in the port yet; construct the "
                "scheduler without prefix_cache")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = device_of(params)
        self._ns = f"sched{next(_SCHED_IDS)}"
        self.stats = SchedStats()
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
        self._decode = jit_decode(model)
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
                    "(repro_torch.pool.default_pool)")
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
        self.prefetcher: Optional[PlanPrefetcher] = None
        self._inflight: Optional[InFlightFetches] = None
        self._fetch_map: Dict[str, Tuple[int, int, int, int, int]] = {}
        if cfg.kv_offload:
            self.prefetcher = PlanPrefetcher(
                model.cfg, cfg.max_batch, cfg.max_seq, pool=self.pool,
                hw=cfg.hw, refine=cfg.refine, insert_opts=cfg.insert_opts,
                plan_cache=plan_cache, tracer=self._tracer)
            self.pool.add_evict_listener(self._on_evict)
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
        return self.queue.push(request)

    @property
    def active(self) -> List[RequestState]:
        return [s for s in self.slots if s is not None]

    def close(self) -> None:
        """Idempotent shutdown: drop remaining pages, unhook from a shared
        pool, close an owned pool."""
        if self._closed:
            return
        self._closed = True
        if self.cfg.kv_offload:
            self.pool.remove_evict_listener(self._on_evict)
        for st in list(self.slots) + list(self.finished.values()):
            if st is not None:
                if st.pages is not None:
                    st.pages.drop()
                self.admission.release(st)
        if self._owns_pool:
            self.pool.close()

    def pool_stats(self) -> Dict[str, Any]:
        return self.pool.snapshot()

    def prefetch_stats(self) -> Optional[Dict[str, float]]:
        return None if self.prefetcher is None else \
            self.prefetcher.stats.snapshot()

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
        the end of the previous step and scatter the pages back into the
        batch cache, in place, on the compute stream (each wait has made
        it wait on its fetch's copy)."""
        fetched = self._inflight.wait_all()
        self._inflight = None
        for key, arr in fetched.items():
            si, pi, j, ri, slot = self._fetch_map[key]
            _flatten(self._subtree(si, pi))[0][j][ri, slot] = arr
        self._fetch_map = {}

    def _reserve_capacity(self, state: RequestState) -> bool:
        """Worst-case capacity reservation (the request's page-key prefix
        ``covers`` its future parked pages — "-" guards req3 vs req30).
        False = capacity pressure."""
        covers = f"{self._ns}/req{state.req_id}-"
        if self.admission.try_admit(state, self._row_bytes, covers):
            return True
        if (not self.active
                and not self.admission.can_ever_admit(self._row_bytes)):
            raise RuntimeError(
                f"request {state.req_id} can never be admitted: "
                f"worst-case pages ({self._row_bytes} B) exceed the "
                "pool's device+host capacity")
        return False   # retirements will free it

    def _try_admit_head(self) -> Optional[Tuple[RequestState, int]]:
        """Admission guard shared by both prefill paths: pop the arrival
        queue's head into a free slot if the pool can hold its worst-case
        pages. Returns (state, slot) or None (no slot / not arrived /
        capacity pressure)."""
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

    def _admit_and_prefill(self) -> List[Tuple[int, int]]:
        if self.cfg.chunk_size is not None:
            return self._admit_and_prefill_chunked()
        emitted = []
        for _ in range(self.cfg.prefill_budget):
            admitted = self._try_admit_head()
            if admitted is None:
                break
            emitted.append(self._join(*admitted))
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
        spent = 0
        for s in sorted(mid, key=lambda s: (s.joined_step, s.req_id)):
            out, spent = self._advance_chunks(s, spent, budget)
            emitted += out
        while spent < budget:
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
        ``_prefill_chunk_step`` calls from here on."""
        self._take_slot(state, slot)
        state.prefill_pos = 0
        state.chunk_cache = self._new_row()

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

    def _take_slot(self, state: RequestState, slot: int) -> None:
        """Join bookkeeping shared by both prefill paths: occupy the batch
        slot and (kv_offload) create the request's page table."""
        state.status = PREFILL
        state.slot = slot
        self.slots[slot] = state
        state.joined_step = self.stats.steps
        state.t_joined = self.now
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
        for big, r in zip(_flatten(self.cache)[0], _flatten(row)[0]):
            big[:, state.slot] = r[:, 0]
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
        if state.pages is not None:
            state.pages.drop()
        self.admission.release(state)
        self.slots[state.slot] = None
        state.slot = None
        self.finished[state.req_id] = state
        self.stats.retires += 1

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
        self._fetch_map = {}
        for s in live:
            prio = float(s.request.max_new_tokens - len(s.out))
            for i, (si, ri, pi) in enumerate(self._flat):
                leaves = _flatten(self._subtree(si, pi))[0]
                for j, leaf in enumerate(leaves):
                    key = s.pages.park(f"L{i}.{j}", leaf[ri, s.slot],
                                       self.pool.top_tier, priority=prio)
                    keys_by_layer.setdefault(i, []).append(key)
                    self._fetch_map[key] = (si, pi, j, ri, s.slot)
                    self.stats.pages_parked += 1
        if keys_by_layer:
            self._inflight = self.prefetcher.issue(keys_by_layer)

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
        admitted slot was free when the fetches were issued, so the
        joiner's freshly scattered rows are never clobbered by collect."""
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
            _steps_for(s) for s in (list(self.queue.pending()) + self.active))

    def run(self, requests: Sequence[Request] = (), *,
            max_steps: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Drive the loop until every submitted request completes. Returns
        req_id -> generated token ids."""
        for r in requests:
            self.submit(r)
        if max_steps is None:
            max_steps = self.default_max_steps()
        steps = 0
        while len(self.queue) or self.active:
            if (not self.active
                    and self.queue.head_ready(self.now) is None):
                self.now = max(self.now, self.queue.next_arrival())  # idle skip
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("scheduler made no progress "
                                   f"({steps} steps, {len(self.queue)} queued)")
        return {rid: st.tokens_array() for rid, st in self.finished.items()}
