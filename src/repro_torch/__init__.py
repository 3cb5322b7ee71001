"""PyTorch/CUDA port of the HyperOffload serving path.

A second package beside the JAX reference (``repro``), with the same module
names: ``configs``, ``models``, ``kernels`` (hand-written Hopper kernels with
plain PyTorch versions beside them), ``core`` (the planner: graph IR, cost
model, cache-op insertion, order refinement), ``pool`` (tiered memory pool
with the Store/Prefetch transfer engine), ``offload.kvcache`` (paged KV
cache, per-request page tables), ``serving``, ``sched`` (the continuous
scheduler with plan-driven prefetch), ``slo.policy`` and ``obs``. It
imports ``torch`` and never ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises (``repro_torch.device``).
"""

__all__ = ["configs", "convert", "core", "device", "kernels", "models",
           "obs", "offload", "pool", "sched", "serving", "slo"]
