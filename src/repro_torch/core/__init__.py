"""HyperOffload core: graph-driven hierarchical memory management (the
port's copy of ``repro.core``; none of it touches a tensor).

- ``ir``         — computation graph with first-class cache operators
- ``costmodel``  — hardware model (compute, HBM, pool links); ``H100`` is
  the port's default spec
- ``lifetime``   — tensor lifetime analysis over an execution order
- ``memsim``     — device-memory ledger: peak usage for a given order
- ``allocator``  — fragmentation-aware allocator simulator (defrag events)
- ``insertion``  — compile-time Prefetch/Store/Detach insertion (§4.2.2)
- ``schedule``   — Algorithm 1: graph-driven execution-order optimization
- ``timeline``   — dual-stream (compute + DMA) execution timeline simulator
- ``planner``    — end-to-end pipeline producing an OffloadPlan
- ``tracer``     — ModelConfig → layer-level graphs (train/prefill/decode)
"""

from repro_torch.core.costmodel import ASCEND_LIKE, H100, TPU_V5E, HardwareSpec
from repro_torch.core.ir import Graph, Node, TensorInfo
from repro_torch.core.planner import HyperOffloadPlanner, OffloadPlan

__all__ = [
    "Graph",
    "Node",
    "TensorInfo",
    "HardwareSpec",
    "ASCEND_LIKE",
    "H100",
    "TPU_V5E",
    "HyperOffloadPlanner",
    "OffloadPlan",
]
