"""Runtime memory pool of the PyTorch port.

- ``topology`` — declarative ``TierTopology``: the spill chain as data;
- ``backend``  — device / pinned-host / CPU / modeled tiers behind one
  interface;
- ``manager``  — capacity-tracked ``MemoryPoolManager`` with priority+LRU
  eviction that spills down the chain;
- ``transfer`` — async ``TransferEngine`` on a CUDA copy stream, with
  explicit wait handles.
"""

from repro_torch.pool.backend import (
    DEVICE_TIER, HOST_TIER, REMOTE_TIER,
    CpuTensorBackend, DeviceBackend, HostBackend, backend_for,
)
from repro_torch.pool.manager import (
    MemoryPoolManager, PoolCapacityError, PoolEntry, TierState, default_pool,
)
from repro_torch.pool.topology import TierSpec, TierTopology
from repro_torch.pool.transfer import (
    TransferEngine, TransferHandle, TransferStats, auto_depth,
)

__all__ = [
    "DEVICE_TIER", "HOST_TIER", "REMOTE_TIER",
    "CpuTensorBackend", "DeviceBackend", "HostBackend", "backend_for",
    "MemoryPoolManager", "PoolCapacityError", "PoolEntry", "TierState",
    "default_pool",
    "TierSpec", "TierTopology",
    "TransferEngine", "TransferHandle", "TransferStats", "auto_depth",
]
