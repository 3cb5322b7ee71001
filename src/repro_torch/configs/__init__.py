"""Architecture registry of the PyTorch port: the configurations it serves
(phi3-mini-3.8b; gemma2-9b for the sliding window and the logit softcaps;
mamba2-370m, attention-free, and zamba2-7b, the Mamba2/attention hybrid)."""

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    LayerSpec,
    ModelConfig,
    Segment,
)
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.phi3_mini_3_8b import CONFIG as PHI3_MINI
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B

REGISTRY = {c.name: c for c in (GEMMA2_9B, MAMBA2_370M, PHI3_MINI,
                                ZAMBA2_7B)}


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
