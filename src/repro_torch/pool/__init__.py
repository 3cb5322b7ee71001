"""Runtime memory pool of the PyTorch port.

- ``topology`` — declarative ``TierTopology``: the spill chain as data;
- ``backend``  — device / pinned-host / CPU / modeled tiers behind one
  interface, and ``CodecBackend`` for the tiers below a codec boundary;
- ``codec``    — int8/fp8 KV page codecs (per-page absmax scales);
- ``manager``  — capacity-tracked ``MemoryPoolManager`` with priority+LRU
  eviction that spills down the chain;
- ``transfer`` — async ``TransferEngine`` on a CUDA copy stream, with
  explicit wait handles;
- ``executor`` — ``OffloadPlanExecutor`` runs a planned graph's order
  against the pool and keeps a residency trace to hold against
  ``core.memsim``'s.
"""

from repro_torch.pool.backend import (
    DEVICE_TIER, HOST_TIER, REMOTE_TIER,
    CodecBackend, CpuTensorBackend, DeviceBackend, HostBackend, backend_for,
)
from repro_torch.pool.codec import (
    CODECS, EncodedPage, Fp8Codec, Int8Codec, KVCodec, make_codec,
    roundtrip_bound, supports_fp8,
)
from repro_torch.pool.manager import (
    MemoryPoolManager, PoolCapacityError, PoolEntry, TierState, default_pool,
)
from repro_torch.pool.topology import TierSpec, TierTopology, sweep_topologies
from repro_torch.pool.transfer import (
    TransferEngine, TransferHandle, TransferStats, auto_depth,
)
from repro_torch.pool.executor import ExecutionTrace, OffloadPlanExecutor

__all__ = [
    "DEVICE_TIER", "HOST_TIER", "REMOTE_TIER",
    "CodecBackend", "CpuTensorBackend", "DeviceBackend", "HostBackend",
    "backend_for",
    "CODECS", "EncodedPage", "Fp8Codec", "Int8Codec", "KVCodec",
    "make_codec", "roundtrip_bound", "supports_fp8",
    "MemoryPoolManager", "PoolCapacityError", "PoolEntry", "TierState",
    "default_pool",
    "TierSpec", "TierTopology", "sweep_topologies",
    "TransferEngine", "TransferHandle", "TransferStats", "auto_depth",
    "ExecutionTrace", "OffloadPlanExecutor",
]
