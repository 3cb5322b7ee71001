"""Random weights made by the benchmark on the device from the run's seed,
in the port's parameter layout, without ``Model.init``.

The layout (leaf names, shapes, types) comes from ``Model.param_specs``,
which allocates nothing. Each type's leaves are views of one flat buffer
filled by one ``normal_`` call of a generator on the device, in the type
they are served in (no float32 draw before a cast), then scaled in place:

- a matrix by ``fan_in ** -0.5``, its fan-in being its next-to-last dim
  (stacked layers ``(L, in, out)``, stacked experts ``(L, E, in, out)``);
- the embedding and the output head by 0.02;
- a norm scale by 0.1 (the port's norms multiply by ``1 + scale``).

The same tensors go to the port and to the reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

EMBED_STD = 0.02
NORM_STD = 0.1


def _leaves(tree, path=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [leaf for k, v in items for leaf in _leaves(v, path + (str(k),))]


def _rebuild(tree, values: Dict[Tuple[str, ...], torch.Tensor], path=()):
    if isinstance(tree, torch.Tensor):
        return values[path]
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (str(k),))
                for k, v in tree.items()}
    return [_rebuild(v, values, path + (str(i),)) for i, v in enumerate(tree)]


def _std(path: Tuple[str, ...], shape: torch.Size) -> float:
    name = path[-1]
    if name in ("scale", "bias", "q_norm", "kv_norm"):
        return NORM_STD
    if name in ("embed", "lm_head"):
        return EMBED_STD
    return shape[-2] ** -0.5


def make_params(model, seed: int, dtype: torch.dtype,
                device: torch.device) -> Dict:
    """The model's parameters, drawn on ``device`` from ``seed``: leaves
    the port keeps in float32 (norms, the MoE router) in float32, the rest
    in ``dtype``."""
    spec = model.param_specs(dtype)
    leaves = _leaves(spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    values: Dict[Tuple[str, ...], torch.Tensor] = {}
    for dt in sorted({t.dtype for _, t in leaves}, key=str):
        group = [(p, t) for p, t in leaves if t.dtype == dt]
        flat = torch.empty(sum(t.numel() for _, t in group), dtype=dt,
                           device=device)
        flat.normal_(0.0, 1.0, generator=gen)
        off = 0
        for p, t in group:
            view = flat[off:off + t.numel()].view(t.shape)
            view.mul_(_std(p, t.shape))
            values[p] = view
            off += t.numel()
    return _rebuild(spec, values)
