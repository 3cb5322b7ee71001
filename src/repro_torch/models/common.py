"""Shared building blocks: norms, rotary embeddings, softcap, init."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def dense_init(shape: Sequence[int], dtype: torch.dtype, device: torch.device,
               generator: Optional[torch.Generator], in_axis: int = 0
               ) -> torch.Tensor:
    """Truncated-normal fan-in init (std fan_in^-1/2, cut at ±2 std), drawn
    in fp32 from ``generator`` and cast. ``shape[in_axis]`` is the fan-in:
    1 for weights stacked (repeats, in, out)."""
    fan_in = shape[in_axis]
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.mul_(fan_in ** -0.5)
    return w.to(dtype)


def embed_init(shape: Sequence[int], dtype: torch.dtype, device: torch.device,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=generator).mul_(0.02)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    # gemma-style (1 + scale) parameterisation keeps zero-init neutral
    return (y * (1.0 + scale.float())).to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float()) + bias.float()).to(dtype)


def norm_params(cfg: ModelConfig, device: torch.device,
                stack: Sequence[int] = ()) -> dict:
    """Norm parameters are fp32 whatever the weights' type, as in the
    reference; ``stack`` prepends the segment's ``repeats`` dimension."""
    shape = tuple(stack) + (cfg.d_model,)
    p = {"scale": torch.zeros(shape, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """Inverse frequencies for rotary embedding, shape (head_dim // 2,)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x`` of shape (B, S, H, D) by ``positions`` (B, S)."""
    d = x.shape[-1]
    half = d // 2
    inv = rope_freqs(d, theta, x.device)
    ang = positions.float()[..., None] * inv[None, None, :]   # (B, S, half)
    sin = torch.sin(ang)[..., None, :]                       # (B, S, 1, half)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
