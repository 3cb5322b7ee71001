"""Hardware model for the SuperNode memory hierarchy (the port's copy of
``repro.core.costmodel``, plus the H100 spec the port plans under).

The paper's platform is an Ascend 910C node attached to a shared memory pool
(CloudMatrix384 Unified Bus); the JAX package's is TPU v5e, the port's one
NVIDIA H100 with pinned host memory as the pool tier. All reduce to the same four numbers per device: peak FLOP/s,
HBM bandwidth, remote-pool bandwidth (per direction), and HBM capacity.
The pool bandwidth is deliberately sweepable — Figure 6 of the paper sweeps
D2H bandwidth 33.6→70 GB/s and we reproduce that experiment directly.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    flops: float              # peak FLOP/s per device (bf16)
    hbm_bw: float             # HBM bytes/s
    hbm_bytes: float          # device memory capacity
    pool_bw_d2r: float        # device -> remote pool bytes/s
    pool_bw_r2d: float        # remote pool -> device bytes/s
    link_bw: float            # inter-chip interconnect bytes/s per link
    dma_issue_overhead: float = 2e-6   # fixed cost to launch one DMA
    runtime_intervention: float = 30e-6  # CPU runtime swap decision cost
                                         # (reactive baseline only, §3.1)

    def with_pool_bw(self, bw: float) -> "HardwareSpec":
        return replace(self, pool_bw_d2r=bw, pool_bw_r2d=bw)

    # ------------------------------------------------------------------
    def compute_time(self, flops: float, hbm_bytes: float) -> float:
        """Roofline node time: max of compute and memory terms."""
        return max(flops / self.flops, hbm_bytes / self.hbm_bw)

    def transfer_time(self, nbytes: float, direction: str) -> float:
        bw = self.pool_bw_d2r if direction == "d2r" else self.pool_bw_r2d
        return self.dma_issue_overhead + nbytes / bw


# TPU v5e (per chip) — the JAX package's target hardware, kept so a plan
# made here under it can be held against the JAX package's.
TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    flops=197e12,
    hbm_bw=819e9,
    hbm_bytes=16e9,
    pool_bw_d2r=50e9,
    pool_bw_r2d=50e9,
    link_bw=50e9,
)

# Ascend-910C-like single device used to reproduce the paper's own numbers.
# The paper's measured D2H bandwidth is 33.6 GB/s (§7.2.1); HBM ~1.6 TB/s
# and ~280 TFLOP/s bf16 per 910C die pair are public figures (the exact
# values only shift absolute times — the reproduced quantities are ratios).
ASCEND_LIKE = HardwareSpec(
    name="ascend_910c_like",
    flops=280e12,
    hbm_bw=1.6e12,
    hbm_bytes=64e9,
    pool_bw_d2r=33.6e9,
    pool_bw_r2d=33.6e9,
    link_bw=56e9,
)

# One NVIDIA H100 SXM (80 GB HBM3) with pinned host memory across PCIe as
# the pool tier — the port's default wherever the JAX package defaults to
# TPU_V5E. flops, hbm_bw, hbm_bytes: NVIDIA's H100 SXM data sheet (dense
# bf16 tensor-core peak, HBM3 rate, capacity). pool_bw_*: the host link as
# the card measured it — chip_smoke.py's offload_kv round trip moves
# 1,811,939,328 B (half each way, the store and the fetch one after the
# other) in 44.3-44.8 ms on an NVIDIA H100 80GB HBM3 at 700 W: about
# 41 GB/s in each direction (PERF.md, section 5). link_bw:
# NVLink's 450 GB/s each way to the other cards of a host (data sheet).
H100 = HardwareSpec(
    name="h100_sxm",
    flops=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    pool_bw_d2r=41e9,
    pool_bw_r2d=41e9,
    link_bw=450e9,
)
