"""Learning-rate schedules."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup → cosine decay to ``floor``·peak, in fp32 (a 0-dim CPU
    tensor, the reference's formula op for op)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, peak_lr * cos)
