"""Dense GQA decoders, Mamba2 and the Mamba2/attention hybrid in PyTorch,
laid out like the JAX reference's ``repro.models`` (stacked per-segment
parameters and caches)."""
