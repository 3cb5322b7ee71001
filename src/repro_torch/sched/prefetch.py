"""Plan-driven KV prefetch for the serving scheduler (§4.3 at runtime; the
port's copy of ``repro.sched.prefetch``).

``PlanPrefetcher`` asks the compiler for a decode-step plan once — it
builds the layer-level decode graph (``core.tracer.trace_decode_step``
with pool-resident KV), runs ``HyperOffloadPlanner`` (cache-op insertion +
Algorithm 1 order refinement) — and then *executes the plan's cache-op
schedule* every serving step: walking the refined order, each
``prefetch::kv_i`` node issues layer *i*'s pages as one async
``TransferEngine`` job (``MemoryPoolManager.prefetch_many``) at its
scheduled slot, which Algorithm 1 placed ahead of the consuming layer's
compute. Where the caller names each page's destination (the scheduler's
batch-cache slots) the job copies the pages straight there. The consumer
waits on the jobs in layer order, so layer *l+1*'s pages are in flight
while layer *l*'s are being consumed, and the scheduler puts the next
step's admission and prefill work between issue and wait — replacing the
reactive store-then-immediately-wait round trip
(`ServeEngine._cache_round_trip`) the paper argues against.

On a CUDA device each job runs on the transfer engine's copy stream and a
wait makes the compute stream wait on the job's copies, so the copies
overlap the compute queued between issue and wait. On the CPU the overlap
is thread-level; semantics and traffic are what a CPU run shows. The plan
is made under ``H100`` unless the caller names another spec.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import H100, HardwareSpec
from repro_torch.core.insertion import PAGED_INSERTION, InsertionOptions
from repro_torch.core.planner import HyperOffloadPlanner, OffloadPlan
from repro_torch.core.tracer import TraceOptions, trace_decode_step
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.pool.manager import MemoryPoolManager
from repro_torch.pool.transfer import TransferHandle


@dataclass
class InFlightFetches:
    """One step's issued page fetches: one job per layer, with the pool
    keys it carries, in the plan's *consumption* order."""

    by_layer: List[Tuple[int, Sequence[str], TransferHandle]]

    def wait_all(self) -> Dict[str, torch.Tensor]:
        """Retire every job in consumption order (layer by layer), so the
        caller's current stream is ordered after all their copies; returns
        the pages of the jobs that were given no destinations, by key."""
        out: Dict[str, torch.Tensor] = {}
        for _, keys, h in self.by_layer:
            pages = h.wait()
            if pages is not None:
                out.update(zip(keys, pages))
        return out


@dataclass
class PrefetchStats:
    steps: int = 0
    fetches_issued: int = 0
    plan_leads: Dict[int, int] = field(default_factory=dict)

    @property
    def mean_plan_lead(self) -> float:
        """Mean number of plan slots between a layer's prefetch and its
        consuming compute node in the refined order (>0 ⇒ fetches are
        scheduled ahead of their consumers)."""
        if not self.plan_leads:
            return 0.0
        return sum(self.plan_leads.values()) / len(self.plan_leads)

    @property
    def mean_fetches_per_step(self) -> float:
        """Observed per-step fetch fan-out — the ``pages_per_step`` input
        to the calibration loop's in-flight sizing."""
        return self.fetches_issued / self.steps if self.steps else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"steps": self.steps, "fetches_issued": self.fetches_issued,
                "layers_planned": len(self.plan_leads),
                "mean_plan_lead": self.mean_plan_lead}


class PlanPrefetcher:
    def __init__(self, cfg: ModelConfig, batch: int, max_seq: int, *,
                 pool: MemoryPoolManager, hw: HardwareSpec = H100,
                 refine: bool = True,
                 insert_opts: Optional[InsertionOptions] = None,
                 plan_cache: Optional[Dict[Any, OffloadPlan]] = None,
                 tracer=None) -> None:
        self.pool = pool
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # insertion options come from the session/config; the fallback is
        # the documented paged default (min_bytes=1 — the mandatory prefetch
        # of every pool-resident KV tensor must be planned even for
        # smoke-scale models)
        opts = insert_opts if insert_opts is not None else PAGED_INSERTION
        # the pool's tier topology joins the key: plans computed under
        # different hierarchies (or a calibrated vs static hw, via hw.name)
        # must never alias
        key = ("decode_plan", cfg.name, batch, max_seq, refine, hw.name, opts,
               getattr(pool, "topology", None))
        if plan_cache is not None and key in plan_cache:
            self.plan = plan_cache[key]
        else:
            g = trace_decode_step(cfg, batch, max_seq,
                                  TraceOptions(remote_kv=True))
            planner = HyperOffloadPlanner(hw, insert_opts=opts)
            self.plan = planner.plan(g, refine=refine)
            if plan_cache is not None:
                plan_cache[key] = self.plan
        pos = {n: i for i, n in enumerate(self.plan.order)}
        # issue schedule: layer index of each prefetch::kv_i, in plan order
        self.issue_order: List[int] = []
        consume_pos: Dict[int, int] = {}
        issue_pos: Dict[int, int] = {}
        for name in self.plan.order:
            node = self.plan.graph.nodes[name]
            if node.kind == "prefetch" and node.tensor.startswith("kv_"):
                layer = int(node.tensor.split("_", 1)[1])
                self.issue_order.append(layer)
                issue_pos[layer] = pos[name]
            elif node.kind == "compute" and name.startswith("dec_"):
                consume_pos[int(name.split("_", 1)[1])] = pos[name]
        self.consumption_order: List[int] = sorted(
            consume_pos, key=consume_pos.get)
        self.stats = PrefetchStats(plan_leads={
            l: consume_pos[l] - issue_pos[l]
            for l in issue_pos if l in consume_pos})

    @property
    def planned_layers(self) -> Sequence[int]:
        return tuple(self.issue_order)

    def issue(self, keys_by_layer: Mapping[int, Sequence[str]],
              dests_by_layer: Optional[
                  Mapping[int, Sequence[torch.Tensor]]] = None
              ) -> InFlightFetches:
        """Issue one step's page fetches in the refined plan order, one job
        per layer (layers whose pages the caller didn't name are skipped —
        e.g. empty slots). With ``dests_by_layer`` each page is copied
        straight into its destination (one per key, in the same order).
        Returns the in-flight jobs in consumption order."""
        issued: Dict[int, Tuple[int, Sequence[str], TransferHandle]] = {}
        t0 = self.tracer.now() if self.tracer.enabled else 0.0
        for layer in self.issue_order:
            keys = keys_by_layer.get(layer)
            if keys:
                dests = None if dests_by_layer is None \
                    else dests_by_layer[layer]
                issued[layer] = (layer, keys,
                                 self.pool.prefetch_many(keys, dests))
                self.stats.fetches_issued += len(keys)
        self.stats.steps += 1
        if self.tracer.enabled:
            self.tracer.complete(
                "sched", "prefetch_issue", t0, self.tracer.now() - t0,
                {"fetches": sum(len(k) for _, k, _ in issued.values()),
                 "layers": len(issued)})
        return InFlightFetches(by_layer=[
            issued[l] for l in self.consumption_order if l in issued])
