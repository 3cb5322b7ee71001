"""Dense GQA decoder models in PyTorch, laid out like the JAX reference's
``repro.models`` (stacked per-segment parameters and caches)."""
