"""`HyperOffloadSession` — the one front door to the runtime (the
counterpart of ``repro.api.session``).

The paper's thesis is a single globally-visible layer owning both the
compile-time plan and the runtime data movement. The session is that layer
on the API surface: it owns exactly **one** `MemoryPoolManager`, **one**
`TransferEngine`, and **one** `HyperOffloadPlanner`, and hands out every
subsystem pre-wired to them:

    cfg = OffloadConfig(mode="kv_offload", max_seq=64)
    with HyperOffloadSession(cfg) as session:
        engine = session.serve_engine(model, params)
        sched  = session.scheduler(model, params)
        cache  = session.paged_kv(batch=2, n_kv_heads=4, head_dim=64)
        ex     = session.executor(graph, compute_fns)
        print(session.stats())          # pool + transfer + serve + sched

Everything the session hands out shares its pool (one capacity ledger, one
eviction hierarchy), its plan cache (a decode-step plan computed for one
scheduler is reused by the next), and its transfer engine — whose in-flight
depth grows to cover the largest consumer via the ``auto`` depth policy
(`pool.auto_depth`) instead of each call site hard-coding its own.

Offload-mode subsystems refuse to build private pools:
`ServeEngine(offload_kv=True)`, `ContinuousScheduler(kv_offload=True)` and
`PagedKVCache.create()` all require an explicit pool — construct through
the session.

With ``config.prefix_cache.enable`` the session also owns one
`PrefixCacheManager` (``repro_torch.prefix``): every scheduler it hands out
shares the same radix index and cached pages, so one request's retired
prompt prefix serves every later scheduler's admissions, and the cached
pages live in the session pool under the same tiering/eviction ledger as
everything else.

The session's pool is on ``device`` (CUDA unless the caller asks for the
CPU); models served through it must have their parameters there.

Training goes through the same door: ``train_config`` builds a
`TrainStepConfig` whose memory policy (``remat``, ``offload_opt_state``,
``host_memory_kind``) comes from the session config, ``train_step`` and
``init_train_state`` build the step and the state under it, on the
session's device:

    with HyperOffloadSession(OffloadConfig(remat="offload",
                                           offload_opt_state=True)) as s:
        ts = s.train_config(peak_lr=1e-3, warmup=10)
        params, opt = s.init_train_state(model, ts=ts)
        step = s.train_step(model, ts)
        params, opt, metrics = step(params, opt, batch)
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from repro_torch.api.config import OffloadConfig
from repro_torch.core.calibration import (
    CalibratedHardwareSpec, calibrate, measurements_from_pairs,
    required_inflight,
)
from repro_torch.core.insertion import PAGED_INSERTION
from repro_torch.core.ir import Graph
from repro_torch.core.planner import HyperOffloadPlanner, OffloadPlan
from repro_torch.core.torch_exec import PlanExecutor
from repro_torch.device import DeviceLike
from repro_torch.obs import NULL_TRACER, MetricsRegistry, OverlapAnalyzer, Tracer
from repro_torch.offload.kvcache import PagedKVCache
from repro_torch.pool import DEVICE_TIER, MemoryPoolManager, default_pool
from repro_torch.prefix import PrefixCacheManager
from repro_torch.sched.scheduler import ContinuousScheduler, SchedulerConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.training.step import TrainStepConfig, make_train_step
from repro_torch.training.step import init_train_state as _init_train_state


def _weighted_plan_lead(pairs: List[tuple]) -> float:
    """Session-level mean plan lead over (prefetch steps, per-scheduler
    mean lead) pairs, weighted by step count — an idle one-step scheduler
    must not skew the session figure the way an unweighted mean of means
    does. Falls back to the unweighted mean when no scheduler has stepped
    yet (all weights zero)."""
    total = sum(steps for steps, _ in pairs)
    if total > 0:
        return sum(steps * lead for steps, lead in pairs) / total
    return sum(lead for _, lead in pairs) / len(pairs)


class HyperOffloadSession:
    """One pool, one transfer engine, one planner — shared by every
    subsystem the session constructs (see module doc)."""

    def __init__(self, config: Optional[OffloadConfig] = None, *,
                 device: DeviceLike = None,
                 pool: Optional[MemoryPoolManager] = None) -> None:
        self.config = config if config is not None else OffloadConfig()
        c = self.config
        # ONE tracer + ONE metrics registry per session, shared by every
        # subsystem it hands out (repro_torch.obs). The registry always
        # exists — stats() is a registry snapshot either way; the tracer is
        # the shared no-op NULL_TRACER unless telemetry is enabled.
        self.registry = MetricsRegistry()
        self.tracer = (Tracer(capacity=c.telemetry.ring_capacity)
                       if c.telemetry.enable else NULL_TRACER)
        self._owns_pool = pool is None
        if pool is None:
            # the config's declarative tier chain (explicit topology, or
            # the default device/host/remote under the legacy capacities)
            pool = default_pool(
                topology=c.tier_topology,
                device=device,
                transfer_depth=c.depth_for(),
                transfer_workers=c.transfer_workers,
                codec=c.kv_codec.codec if c.kv_codec.enabled else None,
                codec_below=c.kv_codec.below_tier,
                tracer=self.tracer if c.telemetry.enable else None)
        elif c.telemetry.enable:
            pool.set_tracer(self.tracer)
        self.pool = pool
        self.transfer = pool.transfer
        if c.transfer_depth != "auto":
            # the pin applies to injected pools too — subsystems must not
            # grow an explicitly configured depth
            self.transfer.ensure_depth(c.depth_for())
            self.transfer.depth_pinned = True
        # the session's *effective* hardware model: starts as the config's
        # static spec; recalibrate() swaps in a measured one
        self.hw = c.hardware
        self.planner = HyperOffloadPlanner(
            self.hw, insert_opts=c.insertion_options(),
            sched_opts=c.schedule)
        self._plan_cache: Dict[Any, OffloadPlan] = {}
        self._engines: List[ServeEngine] = []
        self._schedulers: List[ContinuousScheduler] = []
        self._paged: List[PagedKVCache] = []
        self.prefix_cache: Optional[PrefixCacheManager] = None
        if c.prefix_cache.enable:
            pc = c.prefix_cache
            self.prefix_cache = PrefixCacheManager(
                self.pool, page_size=pc.page_size, max_pages=pc.max_pages,
                min_match_pages=pc.min_match_pages, pin_tier=pc.pin_tier,
                tracer=self.tracer)
        self._register_collectors()
        self._closed = False

    def _register_collectors(self) -> None:
        """Re-home the subsystem stats snapshots onto the registry: each
        legacy counter block (`PoolStats`/`TransferStats` via the pool
        snapshot, `ServeStats`, `SchedStats`+prefetch, paged, prefix)
        becomes a named collector, and ``stats()`` is the registry's
        ``collect()``. Registration order is the stats() key order."""
        reg = self.registry
        # the collectors reach the session through a weak reference: the
        # registry is the session's own (and the schedulers' it hands
        # out), so bound methods would make a reference cycle that keeps a
        # dropped session, with its engines' weights and caches, alive
        # until Python collects cycles
        ref = weakref.ref(self)

        def collector(fn: Callable[["HyperOffloadSession"], Any]):
            return lambda: None if ref() is None else fn(ref())

        reg.register_collector("mode", collector(lambda s: s.config.mode))
        reg.register_collector("pool",
                               collector(lambda s: s.pool.snapshot()))
        reg.register_collector("serve",
                               collector(HyperOffloadSession._collect_serve))
        reg.register_collector("sched",
                               collector(HyperOffloadSession._collect_sched))
        reg.register_collector("paged",
                               collector(HyperOffloadSession._collect_paged))
        reg.register_collector(
            "prefix", collector(lambda s: None if s.prefix_cache is None
                                else s.prefix_cache.snapshot()))
        reg.register_collector("plans_cached",
                               collector(lambda s: len(s._plan_cache)))
        if self.config.telemetry.enable:
            # host- and device-clock readings the reference does not keep
            reg.register_collector(
                "sched_clock",
                collector(HyperOffloadSession._collect_sched_clock))
            reg.register_collector(
                "transfer_clock",
                collector(HyperOffloadSession._collect_transfer_clock))

    def _collect_serve(self) -> Dict[str, Any]:
        serve = {"engines": len(self._engines), "prefill_tokens": 0,
                 "decoded_tokens": 0, "cache_round_trips": 0}
        for e in self._engines:
            serve["prefill_tokens"] += e.stats.prefill_tokens
            serve["decoded_tokens"] += e.stats.decoded_tokens
            serve["cache_round_trips"] += e.stats.cache_round_trips
        return serve

    def _collect_sched(self) -> Dict[str, Any]:
        sched = {"schedulers": len(self._schedulers), "steps": 0, "joins": 0,
                 "retires": 0, "prefill_tokens": 0, "prefill_chunks": 0,
                 "decoded_tokens": 0, "pages_parked": 0, "cold_spills": 0,
                 "prefix_hits": 0, "prefix_hit_tokens": 0,
                 "preemptions": 0, "resumes": 0, "shed": 0,
                 "admission_blocked": 0}
        prefetch = {"steps": 0, "fetches_issued": 0, "layers_planned": 0}
        slo: Optional[Dict[str, int]] = None
        leads: List[tuple] = []
        for s in self._schedulers:
            for k in ("steps", "joins", "retires", "prefill_tokens",
                      "prefill_chunks", "decoded_tokens", "pages_parked",
                      "cold_spills", "prefix_hits", "prefix_hit_tokens",
                      "preemptions", "resumes", "shed"):
                sched[k] += getattr(s.stats, k)
            sched["admission_blocked"] += s.admission.blocked
            snap = s.slo_snapshot()
            if snap is not None:
                if slo is None:
                    slo = dict(snap)
                else:
                    for k, v in snap.items():
                        slo[k] = slo.get(k, 0) + v
            pf = s.prefetch_stats()
            if pf is not None:
                for k in ("steps", "fetches_issued", "layers_planned"):
                    prefetch[k] += int(pf[k])
                leads.append((int(pf["steps"]), pf["mean_plan_lead"]))
        if leads:
            prefetch["mean_plan_lead"] = _weighted_plan_lead(leads)
        sched["prefetch"] = prefetch
        if slo is not None:
            sched["slo"] = slo
        return sched

    def _collect_sched_clock(self) -> Dict[str, Any]:
        out = {"admissions": 0, "queue_wait_s": 0.0, "decode_captures": 0,
               "decode_replays": 0, "decode_eager": 0}
        for s in self._schedulers:
            for k in out:
                out[k] += getattr(s.clock, k)
        return out

    def _collect_transfer_clock(self) -> Dict[str, Any]:
        out = self.transfer.clock()
        out["fetch_jobs"] = self.pool.fetch_jobs
        out["fetch_job_pages"] = self.pool.fetch_job_pages
        return out

    def _collect_paged(self) -> Dict[str, Any]:
        paged = {"caches": len(self._paged), "fetches": 0, "flushes": 0,
                 "tokens": 0}
        for p in self._paged:
            paged["fetches"] += p.fetches
            paged["flushes"] += p.flushes
            paged["tokens"] += p.length
        return paged

    # -- planning -------------------------------------------------------
    def plan(self, graph: Graph, *, key: Optional[Any] = None,
             refine: Optional[bool] = None) -> OffloadPlan:
        """Plan ``graph`` with the session's planner. A hashable ``key``
        memoizes the plan in the session's cache (shared with the
        schedulers' `PlanPrefetcher`s)."""
        refine = self.config.refine if refine is None else refine
        cache_key = None if key is None else (key, refine)
        if cache_key is not None and cache_key in self._plan_cache:
            return self._plan_cache[cache_key]
        plan = self.planner.plan(graph, refine=refine)
        if cache_key is not None:
            self._plan_cache[cache_key] = plan
        return plan

    # -- closed-loop calibration ----------------------------------------
    def _overlap_window_s(self) -> float:
        """Measured overlap window per scheduler step: the
        ``admit_prefill`` span is the host work that sits between one
        step's fetch issue and the next step's wait, i.e. the time budget
        a step's transfers have to hide under. The *median* span, not the
        mean — first-admission spans absorb prefill compilation (hundreds
        of ms against a sub-ms typical step) and a mean window inflated
        by them would under-size prefetch parallelism for every steady
        step. 0.0 without telemetry or before any step ran."""
        durs = sorted(e.dur for e in self.tracer.events()
                      if e.cat == "sched" and e.name == "admit_prefill")
        if not durs:
            return 0.0
        n = len(durs)
        mid = n // 2
        return durs[mid] if n % 2 else (durs[mid - 1] + durs[mid]) / 2.0

    def recalibrate(self) -> CalibratedHardwareSpec:
        """Close the planning loop against measured reality.

        Folds the transfer engine's per tier-pair byte/busy-time table
        (every prefetch, put, spill and blocking get the hierarchy has
        performed so far) into a `CalibratedHardwareSpec`
        (``core.calibration``), then:

        - swaps the session planner for one running on the measured spec
          (every subsequent ``plan()`` uses measured transfer estimates);
        - re-plans every live scheduler (``ContinuousScheduler.replan``) so
          refined prefetch orders and plan leads reflect measured
          bandwidth — the calibrated spec's distinct name also keys fresh
          plan-cache entries, never aliasing static plans;
        - sizes prefetch parallelism to the measured bandwidth-delay
          product: if completing one step's fetches inside the measured
          overlap window needs more in-flight transfers than the engine
          has workers, the engine grows (up to
          ``config.calibration.max_inflight``). On a latency-dominated
          modeled tier this is the difference between serialized sleeps
          (exposed waits) and fully hidden transfers.

        Idempotent under unchanged traffic; cheap enough to call between
        benchmark phases or on a serving-loop cadence. Returns the
        calibrated spec (``pair_bw`` carries the measured table)."""
        cal = self.config.calibration
        measurements = measurements_from_pairs(
            self.transfer.stats.snapshot()["pairs"])
        spec = calibrate(self.hw, measurements,
                         device_tier=DEVICE_TIER,
                         min_transfers=cal.min_transfers,
                         min_bytes=cal.min_bytes)
        self.hw = spec
        self.planner = self.planner.with_hardware(spec)
        # measured in-flight sizing: worst per-step fetch fan-out across
        # the schedulers vs the measured per-step overlap window
        pages_per_step = max(
            (s.prefetcher.stats.mean_fetches_per_step
             for s in self._schedulers if s.prefetcher is not None),
            default=0.0)
        window = self._overlap_window_s()
        need = required_inflight(
            measurements, pages_per_step=pages_per_step, window_s=window,
            device_tier=DEVICE_TIER, cap=cal.max_inflight,
            min_transfers=cal.min_transfers, min_bytes=cal.min_bytes)
        if need > 0:
            self.transfer.ensure_workers(need)
            self.transfer.ensure_depth(need)
        for s in self._schedulers:
            s.replan(spec)
        return spec

    # -- serving --------------------------------------------------------
    def serve_engine(self, model, params, *, max_seq: Optional[int] = None,
                     cache_dtype: Optional[torch.dtype] = None,
                     offload_kv: Optional[bool] = None) -> ServeEngine:
        """A `ServeEngine` over the session pool. Offload behavior follows
        ``config.mode`` (``kv_offload`` ⇒ pool round trips); pass
        ``offload_kv`` to override per engine."""
        offload = self.config.offload_kv if offload_kv is None else offload_kv
        engine = ServeEngine(
            model, params,
            max_seq=self.config.max_seq if max_seq is None else max_seq,
            cache_dtype=cache_dtype if cache_dtype is not None
            else self.config.dtype,
            offload_kv=offload, pool=self.pool, tracer=self.tracer)
        self._engines.append(engine)
        return engine

    def scheduler(self, model, params,
                  cfg: Optional[SchedulerConfig] = None,
                  **overrides) -> ContinuousScheduler:
        """A `ContinuousScheduler` over the session pool and plan cache.
        The `SchedulerConfig` is derived from the session config; keyword
        ``overrides`` (``max_batch=…``, ``prefill_budget=…``, …) or a full
        ``cfg`` replace individual fields."""
        c = self.config
        if cfg is None:
            base: Dict[str, Any] = dict(
                max_batch=c.max_batch, max_seq=c.max_seq,
                prefill_budget=c.prefill_budget, chunk_size=c.chunk_size,
                prefill_tokens=c.prefill_tokens, kv_offload=c.offload_kv,
                cache_dtype=c.dtype, hw=self.hw,
                insert_opts=c.insertion_options(), refine=c.refine,
                slo=c.slo if c.slo.enable else None)
            base.update(overrides)
            if (base["kv_offload"] and c.insertion is None
                    and "insert_opts" not in overrides):
                # a kv_offload override on a non-offload-mode session must
                # still plan the mandatory prefetch of every pool-resident
                # KV tensor — the resident-mode cost-model thresholds would
                # silently filter small KV leaves out of the plan
                base["insert_opts"] = PAGED_INSERTION
            cfg = SchedulerConfig(**base)
        elif overrides:
            raise TypeError("pass either cfg or field overrides, not both")
        sched = ContinuousScheduler(
            model, params, cfg, pool=self.pool,
            plan_cache=self._plan_cache, prefix_cache=self.prefix_cache,
            tracer=self.tracer,
            metrics=self.registry if c.telemetry.enable else None)
        self._schedulers.append(sched)
        return sched

    def paged_kv(self, *, batch: int, n_kv_heads: int, head_dim: int,
                 max_seq: Optional[int] = None,
                 page_size: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None,
                 device_pages: Optional[int] = None) -> PagedKVCache:
        """A `PagedKVCache` storing its pages in the session pool. (Each
        subsystem declares its own depth need to the shared engine — see
        `pool.auto_depth`.) ``device_pages`` sizes the fused decode path's
        device page buffer; on a CUDA pool ``attend_fused`` launches the
        paged-decode kernel (``models.runtime.use_attention_impl("plain")``
        runs its plain version)."""
        max_seq = self.config.max_seq if max_seq is None else max_seq
        page_size = self.config.page_size if page_size is None else page_size
        cache = PagedKVCache.create(
            batch=batch, max_seq=max_seq, page_size=page_size,
            n_kv_heads=n_kv_heads, head_dim=head_dim,
            dtype=dtype if dtype is not None else self.config.dtype,
            pool=self.pool, device_pages=device_pages)
        self._paged.append(cache)
        return cache

    # -- plan execution -------------------------------------------------
    def executor(self, graph: Graph, compute_fns: Mapping[str, Callable]
                 ) -> PlanExecutor:
        """A sync `PlanExecutor` running against the session pool (on its
        device)."""
        return PlanExecutor(graph, compute_fns, pool=self.pool)

    # -- training -------------------------------------------------------
    def train_config(self, **overrides) -> TrainStepConfig:
        """`TrainStepConfig` with the memory policy (remat mode, optimizer
        -state offload, host memory kind) taken from the session config;
        ``overrides`` set the optimization hyperparameters."""
        base: Dict[str, Any] = dict(
            remat=self.config.remat,
            offload_opt_state=self.config.offload_opt_state,
            host_kind=self.config.host_memory_kind)
        base.update(overrides)
        return TrainStepConfig(**base)

    def train_step(self, model, ts: Optional[TrainStepConfig] = None, *,
                   jit: bool = True, **overrides) -> Callable:
        """``make_train_step`` under the session's memory policy (``jit``
        is accepted for the reference's signature and does nothing)."""
        if ts is not None and overrides:
            raise TypeError("pass either ts or field overrides, not both")
        return make_train_step(model, ts or self.train_config(**overrides),
                               jit=jit)

    def init_train_state(self, model,
                         generator: Optional[torch.Generator] = None,
                         dtype: torch.dtype = torch.float32,
                         ts: Optional[TrainStepConfig] = None, **overrides):
        """Parameters and AdamW state on the session's device (the moments
        in host memory under ``offload_opt_state``)."""
        if ts is not None and overrides:
            raise TypeError("pass either ts or field overrides, not both")
        return _init_train_state(model, generator, dtype,
                                 ts=ts or self.train_config(**overrides),
                                 device=self.pool.device)

    # -- observability --------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """One merged snapshot: pool (incl. transfer + per-tier occupancy)
        plus aggregated serve/sched/paged counters across every subsystem
        this session handed out. Implemented as the session registry's
        ``collect()`` (the legacy stats blocks are registered collectors),
        so its counters have one shape whether telemetry is on or off — with
        telemetry on, two more collectors carry clock readings
        (``"sched_clock"``: admissions and their host seconds from submit to
        slot, and the batched decodes captured, replayed and run eager;
        ``"transfer_clock"``: the transfer engine's ``clock()``, and the
        pool's ``fetch_jobs`` and the ``fetch_job_pages`` they carried), and
        one extra ``"telemetry"`` key carries the latency histograms and the
        trace-ring state."""
        out = self.registry.collect()
        if self.config.telemetry.enable:
            out["telemetry"] = {
                "histograms": self.registry.snapshot(),
                "trace": self.tracer.snapshot(),
            }
        return out

    def stats_text(self) -> str:
        """Prometheus-style text exposition of the same snapshot: the
        registry's typed instruments (request-latency histograms) plus the
        flattened collector counters."""
        return self.registry.render_prometheus()

    def overlap(self) -> Optional[Dict[str, Any]]:
        """`OverlapAnalyzer` report (hidden vs exposed transfer time per
        tier pair and per scheduler step) over the current trace ring, or
        ``None`` when telemetry is disabled."""
        if not self.config.telemetry.enable:
            return None
        return OverlapAnalyzer.from_tracer(self.tracer).report()

    def export_trace(self, path: str) -> None:
        """Write the trace ring as a Chrome trace-event / Perfetto JSON
        file. Raises when telemetry is disabled — there is nothing to
        export and silently writing an empty trace would mask the
        misconfiguration."""
        if not self.config.telemetry.enable:
            raise RuntimeError(
                "export_trace requires config.telemetry.enable")
        self.tracer.export(path)

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Idempotent: shut down every subsystem, then the pool (if owned).
        Subsystems never close the shared pool themselves. With
        ``telemetry.trace_path`` set, the trace ring is exported there
        before teardown (the drain in ``pool.close`` emits no new spans
        the consumer could still be interested in)."""
        if self._closed:
            return
        self._closed = True
        for s in self._schedulers:
            s.close()
        for e in self._engines:
            e.close()
        if self.prefix_cache is not None:
            self.prefix_cache.close()
        tp = self.config.telemetry.trace_path
        if self.config.telemetry.enable and tp is not None:
            self.tracer.export(tp)
        if self._owns_pool:
            self.pool.close()

    def __enter__(self) -> "HyperOffloadSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
