"""Tag points of the training forward (the counterpart of JAX's
``checkpoint_name``).

``blocks.apply_layer`` names three values of every layer: ``attn_out``
(the mixer's output after its post-norm), ``mlp_out`` (the FFN's output
after its post-norm) and ``resid`` (the layer's output). Outside a tag
scope each tag point is the plain computation. A remat policy
(``repro_torch.offload.policies``) that acts on names opens a scope for
one forward; the scope then sees every tag point of it:
``sublayer(name, fn, p, *acts)`` runs ``fn(p, *acts)``, whose output (the
first one, when it returns a tuple) is the value ``name``, and
``tag(x, name)`` names a value computed in place.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

#: one layer of a repeat: h -> (h, aux_loss)
Layer = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

_SCOPE = contextvars.ContextVar("repro_torch_tag_scope", default=None)


def sublayer(name: str, fn: Callable, p: Dict, *acts: torch.Tensor) -> Any:
    scope = _SCOPE.get()
    return fn(p, *acts) if scope is None else scope.sublayer(name, fn, p,
                                                             acts)


def tag(x: torch.Tensor, name: str) -> torch.Tensor:
    scope = _SCOPE.get()
    return x if scope is None else scope.tag(x, name)


@contextlib.contextmanager
def tag_scope(scope):
    """Make ``scope`` see the tag points run inside the block."""
    token = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(token)


def run_layers(layers: Sequence[Layer],
               h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One repeat of a segment's pattern: its layers in order, and the sum
    of their aux losses (the reference's ``pattern_body``)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in layers:
        h, a = layer(h)
        aux = aux + a
    return h, aux
