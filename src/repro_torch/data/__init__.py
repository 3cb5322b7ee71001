"""Synthetic training data (the counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import SyntheticTokens, make_batch_specs

__all__ = ["SyntheticTokens", "make_batch_specs"]
