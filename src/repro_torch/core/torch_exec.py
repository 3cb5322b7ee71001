"""Synchronous plan execution on real tensors (the counterpart of
``repro.core.jax_exec``) — a thin wrapper over
``pool.executor.OffloadPlanExecutor``.

``PlanExecutor`` validates the compute bindings eagerly (every compute node
needs a callable), and ``run`` returns one flat environment in which
pool-parked tensors reappear under their names; every cache operator is
driven by the ``MemoryPoolManager``'s tiered backends and transfer engine.
A plan that validates in the compiler runs, and produces values equal to
the everything-resident baseline.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch

from repro_torch.core.ir import Graph
from repro_torch.device import DeviceLike
from repro_torch.pool.executor import OffloadPlanExecutor
from repro_torch.pool.manager import MemoryPoolManager, default_pool


class PlanExecutor:
    """Sync facade: validates fn bindings eagerly, owns a throwaway pool
    per ``run`` unless one is injected (on ``device``, CUDA by default),
    and waits every transfer before returning.

    The front-door spelling is ``session.executor(graph, fns)``
    (``repro_torch.api.HyperOffloadSession``), which injects the session's
    shared pool; ``session=`` here accepts any object with a ``.pool``."""

    def __init__(self, graph: Graph,
                 compute_fns: Mapping[str, Callable],
                 device: DeviceLike = None,
                 pool: Optional[MemoryPoolManager] = None,
                 session: Optional[Any] = None) -> None:
        self.graph = graph
        self.fns = dict(compute_fns)
        self.device = device
        if pool is None and session is not None:
            pool = session.pool
        self._pool = pool
        missing = [n for n, node in graph.nodes.items()
                   if node.kind == "compute" and n not in self.fns]
        if missing:
            raise ValueError(f"no compute fn bound for {missing}")

    def run(self, inputs: Mapping[str, torch.Tensor],
            order: Optional[Sequence[str]] = None
            ) -> Dict[str, torch.Tensor]:
        """``inputs`` must provide every tensor with no producer (weights,
        states, graph inputs). Returns the final environment: device-resident
        tensors plus pool-parked tensors under their names."""
        own_pool = self._pool is None
        pool = self._pool if self._pool is not None else default_pool(
            device=self.device)
        ex = OffloadPlanExecutor(self.graph, pool, self.fns)
        try:
            env, _ = ex.run(inputs, order)
            result = dict(env)
            for t in self.graph.tensors:
                if t not in result and ex._key(t) in pool:
                    result[t] = pool.get(ex._key(t))
            return result
        finally:
            # nothing outlives the call: parked entries are in the result,
            # so drop them from the pool (an injected pool would otherwise
            # keep one exec<N>/ copy of every offloaded tensor per run)
            for t in self.graph.tensors:
                if ex._key(t) in pool:
                    pool.drop(ex._key(t))
            if own_pool:
                pool.close()


def run_baseline(graph: Graph, compute_fns: Mapping[str, Callable],
                 inputs: Mapping[str, torch.Tensor],
                 device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Everything-resident reference execution (no cache ops)."""
    base = graph.residentize()
    return PlanExecutor(base, compute_fns, device=device).run(inputs)
