"""Execute an ``OffloadPlan``'s refined node order against the real pool
(the counterpart of ``repro.pool.executor``).

The executor walks the plan's order driving real transfers through the
``MemoryPoolManager``: ``store`` parks the device tensor in the pool's
store tier, ``prefetch`` issues an async fetch through the transfer engine
at its scheduled position (ahead of the consumer), ``detach`` drops the
device reference.

Beside the values it keeps a byte-exact residency ledger under the same IR
memory semantics as ``core.memsim`` — activations are freed after their
last read, prefetches materialize at issue, detaches free — so the
*executed* residency trace can be held against the *predicted* one:

    plan = HyperOffloadPlanner(hw).plan(g)
    _, trace = OffloadPlanExecutor(plan, pool).run(inputs)
    assert trace.usage == memsim.simulate(plan.graph, plan.order).usage

Compute nodes bind to user callables as in ``core.torch_exec``; unbound
computes (and inputs with no value) materialize ``uint8`` buffers of the
declared size on the pool's device, so a plan can be driven — real
allocations, real pool traffic — without a numerical model attached.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.ir import Graph
from repro_torch.core.memsim import MemoryTrace
from repro_torch.pool.manager import MemoryPoolManager, default_pool
from repro_torch.pool.transfer import TransferHandle

# per-executor pool-key namespace: executors sharing one pool never collide
# on graphs that reuse tensor names
_EXEC_IDS = itertools.count()


@dataclass
class ExecutionTrace:
    """What actually happened: residency ledger + transfer counts."""

    usage: List[int] = field(default_factory=list)  # device bytes after each node
    peak_bytes: int = 0
    peak_pos: int = -1
    prefetches: int = 0
    stores: int = 0
    detaches: int = 0

    def matches(self, predicted: MemoryTrace) -> bool:
        """Executed residency equals memsim's prediction, node for node."""
        return (self.usage == predicted.usage
                and self.peak_bytes == predicted.peak_bytes)


class OffloadPlanExecutor:
    """Runs a planned graph; ``plan`` may be an ``OffloadPlan`` or a
    ``Graph`` (then ``order`` defaults to program order). Without a
    ``pool`` it builds ``default_pool()``, which is on CUDA."""

    def __init__(self, plan, pool: Optional[MemoryPoolManager] = None,
                 compute_fns: Optional[Mapping[str, Callable]] = None,
                 store_tier: Optional[str] = None) -> None:
        if isinstance(plan, Graph):
            self.graph, self.default_order = plan, plan.order()
        else:  # OffloadPlan (duck-typed: avoids a core←pool import cycle)
            self.graph, self.default_order = plan.graph, list(plan.order)
        self.pool = pool if pool is not None else default_pool()
        self.device = self.pool.device
        self.fns = dict(compute_fns or {})
        # default: wherever the pool's topology says offloaded stores land
        self.store_tier = (store_tier if store_tier is not None
                           else self.pool.default_store_tier)
        self._key_ns = f"exec{next(_EXEC_IDS)}"

    def _key(self, tensor: str) -> str:
        return f"{self._key_ns}/{tensor}"

    # ------------------------------------------------------------------
    def run(self, inputs: Optional[Mapping[str, Any]] = None,
            order: Optional[Sequence[str]] = None,
            ) -> Tuple[Dict[str, torch.Tensor], ExecutionTrace]:
        """Returns (final device environment, execution trace). ``inputs``
        provides values for graph inputs (weights/states); remote-initial
        tensors are parked in the pool before the walk starts."""
        graph = self.graph
        order = list(order) if order is not None else list(self.default_order)
        graph.validate_order(order)
        inputs = dict(inputs or {})
        pos = {n: i for i, n in enumerate(order)}

        # last read of each tensor under this order (memsim's free rule)
        last_read: Dict[str, int] = {}
        for name in order:
            for t in graph.nodes[name].reads():
                last_read[t] = pos[name]

        produced = {t for n in graph.nodes.values() for t in n.writes()
                    if n.kind == "compute"}

        env: Dict[str, torch.Tensor] = {}
        pending: Dict[str, TransferHandle] = {}
        cur = 0
        trace = ExecutionTrace()

        def materialize(t: str) -> torch.Tensor:
            if t in inputs:
                return torch.as_tensor(inputs[t]).to(self.device)
            return torch.empty(graph.tensors[t].nbytes, dtype=torch.uint8,
                               device=self.device)

        for t, info in graph.tensors.items():
            if info.initial_location == "remote":
                # standing remote copy (weights/states that start pooled);
                # prefetching soon — hint the pool not to churn it out
                self.pool.put(self._key(t), materialize(t), self.store_tier,
                              priority=float(len(order) - last_read.get(t, 0)))
            elif info.initial_location == "device" and t not in produced:
                env[t] = materialize(t)
                cur += info.nbytes
        trace.peak_bytes, trace.peak_pos = cur, -1

        def settle(t: str) -> None:
            if t in pending:
                env[t] = pending.pop(t).wait()

        def free(t: str) -> None:
            nonlocal cur
            if t in env or t in pending:
                settle(t)
                env.pop(t, None)
                cur -= graph.tensors[t].nbytes

        for i, name in enumerate(order):
            node = graph.nodes[name]
            if node.kind == "compute":
                for t in node.inputs:
                    settle(t)
                new = [t for t in node.outputs if t not in env and t not in pending]
                if name in self.fns:
                    outs = self.fns[name](*[env[t] for t in node.inputs])
                    if not isinstance(outs, (tuple, list)):
                        outs = (outs,)
                    if len(outs) != len(node.outputs):
                        raise ValueError(
                            f"{name}: fn returned {len(outs)} values for "
                            f"{len(node.outputs)} declared outputs")
                    for t, v in zip(node.outputs, outs):
                        env[t] = v
                else:
                    for t in node.outputs:
                        env[t] = materialize(t)
                cur += sum(graph.tensors[t].nbytes for t in new)
            elif node.kind == "prefetch":
                t = node.tensor
                if t not in env and t not in pending:
                    # async issue at the scheduled slot; the consumer waits
                    pending[t] = self.pool.prefetch(self._key(t))
                    cur += graph.tensors[t].nbytes
                    trace.prefetches += 1
            elif node.kind == "store":
                t = node.tensor
                settle(t)
                self.pool.put(self._key(t), env[t], self.store_tier,
                              priority=float(len(order) - i))
                trace.stores += 1
            elif node.kind == "detach":
                free(node.tensor)
                trace.detaches += 1
            # memsim's rule: activations die after their last read
            for t in node.reads():
                if (graph.tensors[t].klass == "activation"
                        and last_read.get(t, -1) == i):
                    free(t)
            if cur > trace.peak_bytes:
                trace.peak_bytes, trace.peak_pos = cur, i
            trace.usage.append(cur)

        for t in list(pending):
            settle(t)
        return env, trace
