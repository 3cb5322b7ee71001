"""Architecture registry of the PyTorch port: the configurations it serves
(phi3-mini-3.8b and codeqwen1.5-7b, dense; gemma2-9b for the sliding window
and the logit softcaps; granite-moe-3b-a800m and mixtral-8x22b,
mixture-of-experts; minicpm3-4b, multi-head latent attention; mamba2-370m,
attention-free, and zamba2-7b, the Mamba2/attention hybrid; whisper-medium,
an encoder-decoder with cross-attention; qwen2-vl-72b, vision embeds under
M-RoPE)."""

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    LayerSpec,
    ModelConfig,
    Segment,
)
from repro_torch.configs.codeqwen1_5_7b import CONFIG as CODEQWEN1_5_7B
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.minicpm3_4b import CONFIG as MINICPM3_4B
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.phi3_mini_3_8b import CONFIG as PHI3_MINI
from repro_torch.configs.qwen2_vl_72b import CONFIG as QWEN2_VL_72B
from repro_torch.configs.whisper_medium import CONFIG as WHISPER_MEDIUM
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B

REGISTRY = {c.name: c for c in (CODEQWEN1_5_7B, GEMMA2_9B, GRANITE_MOE,
                                MAMBA2_370M, MINICPM3_4B, MIXTRAL_8X22B,
                                PHI3_MINI, QWEN2_VL_72B, WHISPER_MEDIUM,
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
