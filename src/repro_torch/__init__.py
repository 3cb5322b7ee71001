"""PyTorch/CUDA port of HyperOffload's serving and training paths.

A second package beside the JAX reference (``repro``), with the same module
names: ``configs``, ``models``, ``kernels`` (hand-written Hopper kernels with
plain PyTorch versions beside them), ``core`` (the planner: graph IR, cost
model, cache-op insertion, order refinement), ``pool`` (tiered memory pool
with the Store/Prefetch transfer engine), ``offload.kvcache`` (paged KV
cache, per-request page tables), ``serving``, ``sched`` (the continuous
scheduler with plan-driven prefetch), ``slo``, ``prefix``, ``obs``,
training (``optim``, ``training``, ``offload.policies`` and
``offload.optstate`` for activation and optimizer-state offload, ``data``,
``checkpoint``), the front door ``api`` (``OffloadConfig``,
``HyperOffloadSession``) and the launchers ``launch.serve`` and
``launch.train``. It imports ``torch`` and never ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises (``repro_torch.device``).
"""

__all__ = ["api", "checkpoint", "configs", "convert", "core", "data",
           "device", "kernels", "launch", "models", "obs", "offload",
           "optim", "pool", "prefix", "sched", "serving", "slo", "training"]
