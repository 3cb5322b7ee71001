"""Architecture registry of the PyTorch port: the configurations this slice
serves (phi3-mini-3.8b, and gemma2-9b for the sliding window and the logit
softcaps)."""

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    LayerSpec,
    ModelConfig,
    Segment,
)
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.phi3_mini_3_8b import CONFIG as PHI3_MINI

REGISTRY = {c.name: c for c in (GEMMA2_9B, PHI3_MINI)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = [
    "REGISTRY",
    "get_config",
    "ModelConfig",
    "InputShape",
    "INPUT_SHAPES",
    "LayerSpec",
    "Segment",
]
