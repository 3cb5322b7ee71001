"""Synthetic training data (the counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import SyntheticTokens

__all__ = ["SyntheticTokens"]
