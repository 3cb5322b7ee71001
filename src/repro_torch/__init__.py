"""PyTorch/CUDA port of the HyperOffload serving path.

A second package beside the JAX reference (``repro``), with the same module
names: ``configs``, ``models``, ``kernels`` (hand-written Hopper kernels with
plain PyTorch versions beside them), ``pool`` (tiered memory pool with the
Store/Prefetch transfer engine), ``offload.kvcache`` (paged KV cache),
``serving`` and ``obs``. It imports ``torch`` and never ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises (``repro_torch.device``).
"""

__all__ = ["configs", "convert", "device", "kernels", "models", "obs",
           "offload", "pool", "serving"]
