"""AdamW, from scratch (the counterpart of ``repro.optim.adamw``).

Moments are kept in fp32 whatever the parameter dtype. The update runs
under ``torch.no_grad()`` and writes the parameters and the moments in
place (the reference donates their buffers to the jitted step instead),
one (leaf, layer) slice at a time: a stacked leaf under ``segments`` is
updated layer by layer, every other leaf whole, and a slice of more than
``SLICE_NUMEL`` elements in pieces along its first dimension (phi3-mini's
embedding in three). The fp32 temporaries of
the update therefore never exceed a few slices, and the optimizer-state
offload (``repro_torch.offload.optstate``) streams the moments of exactly
these slices between pinned host memory and the device.

The arithmetic is the reference's, op for op and in fp32: a global-norm
clip with ``1e-9`` in the denominator, bias corrections from ``step + 1``,
weight decay on the parameter in fp32, the result cast back to the
parameter's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-dim int32, on the CPU (no device sync to read)
    mu: Any               # first moments (fp32 tree)
    nu: Any               # second moments (fp32 tree)


def tree_items(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in the reference's order: dict keys sorted, list
    and tuple items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree


def tree_map(fn: Callable, tree: Any) -> Any:
    return tree_map_with_path(lambda _, x: fn(x), tree)


def tree_map_with_path(fn: Callable[[Tuple, Any], Any], tree: Any,
                       path: Tuple = ()) -> Any:
    """The same nesting, each leaf ``x`` at ``path`` replaced by
    ``fn(path, x)``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def is_stacked(path: Tuple) -> bool:
    """A leaf stacked along a leading layer dimension: every leaf under
    ``segments`` (a segment's ``repeats``) and under the encoder's
    ``layers``, as the model lays its layers out."""
    return bool(path) and (path[0] == "segments"
                           or tuple(path[:2]) == ("encoder", "layers"))


#: the most elements one slice holds: a larger (leaf, layer) slice (an
#: embedding, a wide layer) is cut along its first dimension
SLICE_NUMEL = 1 << 25


def _cut(x: torch.Tensor) -> List[torch.Tensor]:
    if x.numel() <= SLICE_NUMEL or x.dim() == 0:
        return [x]
    rows = max(1, SLICE_NUMEL // max(1, x[0].numel()))
    return list(x.split(rows, dim=0))


def leaf_slices(tree: Any) -> List[torch.Tensor]:
    """The (leaf, layer) slices of a tree, in the reference's leaf order:
    views, one per layer of a stacked leaf, every other leaf whole; any of
    them larger than ``SLICE_NUMEL`` elements cut along its first
    dimension."""
    out: List[torch.Tensor] = []
    for path, leaf in tree_items(tree):
        for x in (leaf.unbind(0) if is_stacked(path) else [leaf]):
            out.extend(_cut(x))
    return out


def adamw_init(params: Any) -> AdamWState:
    """fp32 zero moments beside each parameter, on its device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@dataclasses.dataclass(frozen=True)
class Hyper:
    """The update's scalars for one step, as fp32 values."""
    lr: float
    bc1: float
    bc2: float
    b1: float
    b2: float
    eps: float
    weight_decay: float


def hyper(step: torch.Tensor, lr, *, b1: float, b2: float, eps: float,
          weight_decay: float) -> Hyper:
    """Bias corrections from ``step`` (already ``state.step + 1``) in fp32,
    as the reference computes them."""
    t = torch.as_tensor(step).to(torch.float32)
    f32 = lambda x: float(torch.as_tensor(x, dtype=torch.float32))
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), t)
    return Hyper(lr=f32(lr), bc1=f32(bc1), bc2=f32(bc2), b1=b1, b2=b2,
                 eps=eps, weight_decay=weight_decay)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient slice, in fp32 (a
    0-dim tensor on the gradients' device)."""
    total = None
    for g in grads:
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_factor(gn: torch.Tensor, grad_clip: float) -> torch.Tensor:
    return torch.clamp(grad_clip / (gn + 1e-9), max=1.0)


@torch.no_grad()
def update_slice(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, clip: torch.Tensor, h: Hyper) -> None:
    """One slice of the update, in place: moments ``m``/``v`` (fp32, on
    ``p``'s device) and the parameter ``p``."""
    g32 = g.float() * clip
    torch._foreach_mul_([m, v], [h.b1, h.b2])
    torch._foreach_add_([m, v], [g32 * (1 - h.b1),
                                 torch.square(g32) * (1 - h.b2)])
    p32 = p.float()
    delta = (m / h.bc1) / (torch.sqrt(v / h.bc2) + h.eps) \
        + h.weight_decay * p32
    p.copy_((p32 - h.lr * delta).to(p.dtype))


SliceStream = Callable[[List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]], torch.Tensor, Hyper], None]


def resident_update(work, clip: torch.Tensor, h: Hyper) -> None:
    """Every slice updated where its moments are (on the device)."""
    for p, g, m, v in work:
        update_slice(p, g, m, v, clip, h)


def adamw_update(grads: Any, state: AdamWState, params: Any, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 stream: Optional[SliceStream] = None
                 ) -> Tuple[Any, AdamWState, torch.Tensor]:
    """Returns ``(params, state, grad_norm)``: the parameters and the
    state's moments are updated in place (the returned trees are the same
    objects); ``grad_norm`` is the fp32 global norm before the clip.

    ``grads`` mirrors ``params``. ``stream`` runs the per-slice work where the
    moments are elsewhere (``offload.optstate.streamed_update``); by
    default they sit on the device beside the parameters."""
    g_slices = leaf_slices(grads)
    work = list(zip(leaf_slices(params), g_slices, leaf_slices(state.mu),
                    leaf_slices(state.nu)))
    if len(work) != len(g_slices):
        raise ValueError("grads, params and moments differ in structure")
    with torch.no_grad():
        gn = global_norm(g_slices)
        clip = clip_factor(gn, grad_clip)
        step = state.step + 1
        h = hyper(step, lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
        (stream or resident_update)(work, clip, h)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gn
