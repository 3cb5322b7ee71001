"""Divisibility-safe logical→physical sharding rules (the counterpart of
``repro.sharding.rules``).

Model code annotates tensors with *logical* axis names ("batch", "embed",
"mlp", "heads", "kv_heads", "vocab", "seq", "experts", ...). A rule-set maps
each logical name to zero or more mesh axes. :func:`logical_spec` resolves
names to a spec in the reference's ``PartitionSpec`` form (one entry per
tensor dim: ``None``, a mesh axis name or a tuple of names), dropping any
mesh axis that does not evenly divide its dimension: GQA kv=8 on a 16-way
model axis, 40 experts on a 16-way axis, batch=1 decode, etc. degrade to
replication instead of failing.

The 2-D FSDP×TP scheme of the reference:
  - "fsdp"-ish sharding over the ``data`` axis (d_model / vocab rows)
  - tensor parallelism over the ``model`` axis (heads / d_ff / vocab cols)
  - batch over ``("pod", "data")`` when the pod axis exists

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``; the spec
arithmetic reads only its axis names and sizes, so any object with
``axis_names`` and ``devices.shape`` (the reference's ``Mesh`` attributes)
serves there too. :func:`to_placements` turns a spec into ``DTensor``
placements, one per **mesh** dim; :func:`constrain` redistributes a
``DTensor`` to them inside an :func:`axis_rules` context that carries a
mesh, the counterpart of ``with_sharding_constraint``. Under a mesh the
context also turns on ``implicit_replication``: a plain tensor the model
makes (positions, masks, a zero aux loss) meets the ``DTensor`` weights as
a replicated one.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
AxisRules = Dict[str, MeshAxes]
#: one entry per tensor dim, as the reference's ``PartitionSpec``
Spec = Tuple[MeshAxes, ...]

# Single-pod production mesh: ("data", "model") = (16, 16).
DEFAULT_RULES: AxisRules = {
    "batch": ("data",),
    "seq": None,
    "embed": ("data",),          # fsdp: shard the d_model rows of weights
    "embed_act": None,           # activations keep d_model replicated
    "seq_act": None,             # sequence parallelism: the residual stream's
                                 # seq dim shards over "model" at layer
                                 # boundaries when the launcher enables it
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "q_dim": ("model",),
    "kv_dim": ("model",),
    "vocab": ("model",),
    "experts": None,             # 40/8 experts do not divide 16
    "expert_mlp": ("model",),
    "cache_seq": None,
    "cache_batch": ("data",),
    "cache_heads": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "ssm_state": None,
    "layers": None,
    "lora": None,
    "frames": None,
}

# Two-pod mesh: ("pod", "data", "model"): batch additionally over pods,
# weights replicated across pods (data-parallel pods).
MULTIPOD_RULES: AxisRules = dict(
    DEFAULT_RULES,
    batch=("pod", "data"),
    cache_batch=("pod", "data"),
)

_active_rules: contextvars.ContextVar[Optional[AxisRules]] = \
    contextvars.ContextVar("repro_torch_axis_rules", default=None)
_active_mesh: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def axis_rules(rules: AxisRules, mesh=None):
    """Activate a logical-axis rule-set (and optionally a mesh) for model
    code; with a mesh, plain tensors meet ``DTensor``s as replicated."""
    t1 = _active_rules.set(rules)
    t2 = _active_mesh.set(mesh)
    try:
        if mesh is not None and not _replicating_plain():
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _active_rules.reset(t1)
        _active_mesh.reset(t2)


def _replicating_plain() -> bool:
    """Whether ``implicit_replication`` is on already: it is one flag for
    the process, which its own exit clears, so a nested context (a
    recompute in the backward) leaves it to the outer one."""
    from torch.distributed.tensor import DTensor
    return DTensor._op_dispatcher._allow_implicit_replication


def current_rules() -> Optional[AxisRules]:
    return _active_rules.get()


def current_mesh():
    return _active_mesh.get()


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of any object with the
    reference mesh's ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _mesh_axis_size(mesh, axes: Tuple[str, ...]) -> int:
    if mesh is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def logical_spec(dims: Sequence[int], names: Sequence[Optional[str]],
                 rules: Optional[AxisRules] = None, mesh=None) -> Spec:
    """Resolve logical axis names for a shape to a spec.

    Mesh axes that do not evenly divide the dimension are dropped (the
    longest dividing prefix of the mapping is kept). An axis already
    consumed by an earlier dimension is dropped too (a spec must not repeat
    mesh axes).
    """
    rules = rules if rules is not None else (current_rules() or {})
    mesh = mesh if mesh is not None else current_mesh()
    used = set()
    parts = []
    for dim, name in zip(dims, names):
        if name is None:
            parts.append(None)
            continue
        mapped = rules.get(name)
        if mapped is None:
            parts.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            parts.append(None)
            continue
        if mesh is not None:
            size = _mesh_axis_size(mesh, axes)
            if size == 0 or dim % max(size, 1) != 0:
                # try progressively shorter prefixes
                while axes and dim % _mesh_axis_size(mesh, axes) != 0:
                    axes = axes[:-1]
                if not axes:
                    parts.append(None)
                    continue
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    return tuple(parts)


def to_placements(spec: Spec, mesh) -> tuple:
    """``DTensor`` placements (one per mesh dim) of a spec: ``Shard(d)`` on
    every mesh dim that tensor dim ``d`` names, ``Replicate()`` elsewhere.
    A tensor dim over several mesh axes is split major to minor in the
    spec's order, which must be the mesh's order (``("pod", "data")`` on
    ``("pod", "data", "model")``): ``DTensor`` splits a dim over its mesh
    dims in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} splits over {axes}, "
                             f"against the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named_sharding(mesh, dims: Sequence[int], names: Sequence[Optional[str]],
                   rules: Optional[AxisRules] = None) -> Tuple[object, tuple]:
    """The ``(mesh, placements)`` pair of a logical annotation."""
    return mesh, to_placements(logical_spec(dims, names, rules, mesh), mesh)


def constrain(x: torch.Tensor, names: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """Apply a logical sharding constraint if a rule-set is active.

    Outside any :func:`axis_rules` context (unit tests, single-device runs)
    this is the identity, so model code is unconditionally annotated. With
    rules but no mesh a plain tensor is left alone. Under a mesh the tensor
    (a plain one taken as replicated) is redistributed to the resolved
    placements.
    """
    rules = current_rules()
    if rules is None:
        return x
    mesh = current_mesh()
    spec = logical_spec(x.shape, names, rules, mesh)
    if mesh is None or all(p is None for p in spec):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    placements = to_placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)
