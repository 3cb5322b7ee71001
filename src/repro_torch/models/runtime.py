"""Attention backend selection (the counterpart of ``repro.models.runtime``,
whose ``"xla"``/``"pallas"`` become ``"plain"``/``"kernel"`` here).

Tensors on the CPU always take the plain PyTorch path. Tensors on a CUDA
device take the hand-written kernels (``"kernel"``, the default);
``use_attention_impl("plain")`` switches a CUDA run to the plain path, which
exists so a check can compare the two on the card, and which training takes
(the kernels are forward-only). The choice is a context variable, as are
the sharding rules and mesh (``sharding.rules.axis_rules``): code that runs
later on another thread (a recompute in the backward, on autograd's device
thread) re-enters what it captured (:func:`under_forward_context`).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.sharding.rules import axis_rules, current_mesh, current_rules

IMPLS = ("plain", "kernel")
_attn_impl = contextvars.ContextVar("repro_torch_attn_impl", default="kernel")


def attention_impl(device: torch.device) -> str:
    """The attention path for tensors on ``device``."""
    if torch.device(device).type == "cpu":
        return "plain"
    return _attn_impl.get()


def selected_impl() -> str:
    """The path ``use_attention_impl`` selected for CUDA tensors here."""
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


def under_forward_context(fn):
    """``fn`` run under the attention path, and the sharding rules and
    mesh, in force where it is wrapped: a recompute in the backward runs on
    autograd's device thread, where the context variables that selected
    them in the forward are unset."""
    impl, rules, mesh = _attn_impl.get(), current_rules(), current_mesh()

    def run(*args):
        with use_attention_impl(impl):
            if rules is None:
                return fn(*args)
            with axis_rules(rules, mesh):
                return fn(*args)
    return run
