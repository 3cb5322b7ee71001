"""Logical sharding assignment for parameter / optimizer / cache / batch
trees (the counterpart of ``repro.launch.shardings``).

Leaves are matched by their final key name and mapped to logical axis
tuples; ``sharding.rules.logical_spec`` resolves those against the mesh,
dropping any axis that does not divide evenly (GQA kv=8 on a 16-way model
axis, 40 experts, batch=1, ...). Extra *leading* dimensions (the stacked
per-segment ``repeats`` axis, which the port keeps as the reference does)
are padded with the "layers" logical name (unsharded).

The trees are the port's nested dicts and lists of tensors (or of
anything with ``shape`` and ``ndim``). Each ``*_shardings`` returns the
same tree with a :class:`Sharding` per leaf: the reference's spec and its
``DTensor`` placements. :func:`place` turns a tensor tree into
``DTensor``s by those shardings.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.adamw import tree_map_with_path
from repro_torch.sharding.rules import (
    AxisRules,
    Spec,
    logical_spec,
    mesh_axis_sizes,
    to_placements,
)

# final-path-key -> logical names for the *trailing* dims
PARAM_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    # attention
    "wq": ("embed", "q_dim"),
    "wk": ("embed", "kv_dim"),
    "wv": ("embed", "kv_dim"),
    "wo": ("q_dim", "embed"),
    "xwq": ("embed", "q_dim"),
    "xwk": ("embed", "kv_dim"),
    "xwv": ("embed", "kv_dim"),
    "xwo": ("q_dim", "embed"),
    # MLA
    "wdq": ("embed", "lora"),
    "wuq": ("lora", "q_dim"),
    "wdkv": ("embed", "lora"),
    "wkr": ("embed", None),
    "wukv": ("lora", "q_dim"),
    "q_norm": (None,),
    "kv_norm": (None,),
    # dense mlp
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    "w_in": ("embed", "mlp"),
    "w_out": ("mlp", "embed"),
    # router (E small: replicated)
    "router": ("embed", None),
    # mamba2
    "in_proj": ("embed", "ssm_inner"),
    "out_proj": ("ssm_inner", "embed"),
    "conv_w": (None, "ssm_inner"),
    "conv_b": ("ssm_inner",),
    "A_log": ("ssm_heads",),
    "D": ("ssm_heads",),
    "dt_bias": ("ssm_heads",),
    "gate_norm": ("ssm_inner",),
    # norms
    "scale": (None,),
    "bias": (None,),
}

# MoE expert tensors are 3-D (E, ·, ·): expert dim first
MOE_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    "w_gate": ("experts", "embed", "expert_mlp"),
    "w_up": ("experts", "embed", "expert_mlp"),
    "w_down": ("experts", "expert_mlp", "embed"),
}

CACHE_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    "k": ("cache_batch", "cache_seq", "cache_heads", None),
    "v": ("cache_batch", "cache_seq", "cache_heads", None),
    "xk": ("cache_batch", "frames", "cache_heads", None),
    "xv": ("cache_batch", "frames", "cache_heads", None),
    "ckv": ("cache_batch", "cache_seq", None),
    "krope": ("cache_batch", "cache_seq", None),
    "conv": ("cache_batch", "ssm_inner", None),
    "ssm": ("cache_batch", "ssm_heads", None, None),
}

BATCH_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    "tokens": ("batch", None),
    "targets": ("batch", None),
    "token": ("batch", None),
    "enc_embeds": ("batch", None, None),
    "vision_embeds": ("batch", None, None),
    "vision_mask": ("batch", None),
    "positions": (None, "batch", None),
}


class Sharding(NamedTuple):
    spec: Spec            # the reference's PartitionSpec entries
    placements: tuple     # one per mesh dim


def _leaf_name(path) -> str:
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


def _spec_for(path, leaf, table: Dict[str, Tuple[Optional[str], ...]],
              rules: AxisRules, mesh) -> Spec:
    """The reference's rule: an ``ffn`` leaf of ndim >= 3 named as an
    expert tensor takes ``MOE_LOGICAL``; any other leaf its table entry,
    with leading dims named "layers"; an unknown leaf is replicated."""
    name = _leaf_name(path)
    keys = [k for k in path if isinstance(k, str)]
    logical = None
    if name in MOE_LOGICAL and "ffn" in keys and leaf.ndim >= 3:
        cand = MOE_LOGICAL[name]
        if leaf.ndim >= len(cand):
            logical = cand
    if logical is None:
        logical = table.get(name)
    if logical is None:
        return ()
    lead = leaf.ndim - len(logical)
    if lead < 0:
        return ()
    names = ("layers",) * lead + tuple(logical)
    return logical_spec(tuple(leaf.shape), names, rules, mesh)


def _shardings(tree: Any, table, mesh, rules: AxisRules) -> Any:
    def f(path, leaf):
        spec = _spec_for(path, leaf, table, rules, mesh)
        return Sharding(spec, to_placements(spec, mesh))
    return tree_map_with_path(f, tree)


def param_shardings(params_spec: Any, mesh, rules: AxisRules) -> Any:
    """Shardings for a params (or optimizer-moments) tree."""
    return _shardings(params_spec, PARAM_LOGICAL, mesh, rules)


def cache_shardings(cache_spec: Any, mesh, rules: AxisRules) -> Any:
    return _shardings(cache_spec, CACHE_LOGICAL, mesh, rules)


def batch_shardings(batch_spec: Any, mesh, rules: AxisRules) -> Any:
    return _shardings(batch_spec, BATCH_LOGICAL, mesh, rules)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's shard shape of a global ``shape`` under ``spec``."""
    sizes = mesh_axis_sizes(mesh)
    out = list(shape)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            out[d] //= sizes[a]
    return tuple(out)


def local_bytes(tree: Any, shardings: Any, mesh) -> int:
    """Bytes of one device's shards of a tree of tensors (or specs)."""
    total = 0

    def f(path, leaf):
        nonlocal total
        sh = _at(shardings, path)
        n = 1
        for s in local_shape(tuple(leaf.shape), sh.spec, mesh):
            n *= s
        total += n * leaf.dtype.itemsize
    tree_map_with_path(f, tree)
    return total


def _at(tree: Any, path: Tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def place(tree: Any, shardings: Any, mesh) -> Any:
    """The tensors of ``tree`` as ``DTensor``s on ``mesh`` by
    ``shardings``. On a one-device mesh every shard is the whole tensor,
    so a tensor is wrapped as it is, with no copy. A ``meta`` tensor (a
    shape spec) becomes an empty local shard in the current mode: under
    ``FakeTensorMode`` (the dry-run) a fake one, allocating nothing."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def f(path, t):
        sh = _at(shardings, path)
        if t.device.type == "meta":
            loc = torch.empty(local_shape(tuple(t.shape), sh.spec, mesh),
                              dtype=t.dtype, device=mesh.device_type)
            return DTensor.from_local(loc, mesh, sh.placements,
                                      run_check=False, shape=t.shape,
                                      stride=t.stride())
        if mesh.size() == 1:
            return DTensor.from_local(t, mesh, sh.placements, run_check=False)
        return distribute_tensor(t, mesh, sh.placements)
    return tree_map_with_path(f, tree)
