"""Feed-forward blocks: SwiGLU and GELU MLPs."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init


def init_swiglu_params(cfg: ModelConfig, dtype: torch.dtype,
                       device: torch.device, generator: torch.Generator,
                       stack: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    st, ax = tuple(stack), len(stack)
    return {
        "w_gate": dense_init(st + (d, f), dtype, device, generator, ax),
        "w_up": dense_init(st + (d, f), dtype, device, generator, ax),
        "w_down": dense_init(st + (f, d), dtype, device, generator, ax),
    }


def init_gelu_params(cfg: ModelConfig, dtype: torch.dtype,
                     device: torch.device, generator: torch.Generator,
                     stack: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    st, ax = tuple(stack), len(stack)
    return {
        "w_in": dense_init(st + (d, f), dtype, device, generator, ax),
        "w_out": dense_init(st + (f, d), dtype, device, generator, ax),
    }


def swiglu(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def gelu_mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]
