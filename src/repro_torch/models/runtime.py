"""Attention backend selection (the counterpart of ``repro.models.runtime``,
whose ``"xla"``/``"pallas"`` become ``"plain"``/``"kernel"`` here).

Tensors on the CPU always take the plain PyTorch path. Tensors on a CUDA
device take the hand-written kernels (``"kernel"``, the default);
``use_attention_impl("plain")`` switches a CUDA run to the plain path, which
exists so a check can compare the two on the card.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

IMPLS = ("plain", "kernel")
_attn_impl = contextvars.ContextVar("repro_torch_attn_impl", default="kernel")


def attention_impl(device: torch.device) -> str:
    """The attention path for tensors on ``device``."""
    if torch.device(device).type == "cpu":
        return "plain"
    return _attn_impl.get()


@contextlib.contextmanager
def use_attention_impl(name: str):
    if name not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got {name!r}")
    tok = _attn_impl.set(name)
    try:
        yield
    finally:
        _attn_impl.reset(tok)
