"""Rematerialization policies, activation offload among them (the
counterpart of ``repro.offload.policies``; the paper's §5.1, case 1).

The training forward runs each repeat of a segment's layer pattern through
a policy, as the reference wraps it in ``jax.checkpoint(body, policy=...)``.
A policy's ``bind()`` starts one forward and returns its runner,
``run(layers, h) -> (h, aux)``, which runs one repeat's layers:

- ``remat_policy("nothing")`` recomputes the whole repeat in the backward
  from its input (``torch.utils.checkpoint``, non-reentrant);
- ``"everything"`` keeps every activation (no recompute);
- ``"dots"`` keeps the outputs of matrix products without batch
  dimensions (``aten.mm``/``addmm``) and recomputes the rest (selective
  checkpointing);
- ``"save_resid"`` keeps only the tagged ``resid`` values (each layer's
  output): every layer is recomputed from its input;
- ``offload_remat_policy(names)`` keeps the tagged values ``names`` across
  forward→backward **in host memory** and recomputes everything else: the
  reference's ``save_and_offload_only_these_names(names_which_can_be_saved=
  [], names_which_can_be_offloaded=names)``.

The offload policy cuts each layer at its tag points (``models.remat``)
into stages: the mixer (input: the layer's input, output ``attn_out``) and
the FFN (inputs: the layer's input and ``attn_out``, whose sum it rebuilds;
outputs ``mlp_out``, the sum and the aux loss, an MoE FFN's gradient
taken in with the others). A stage runs without keeping anything; each
tagged value is copied to host memory the moment it is made (on CUDA:
into pinned memory, on a copy stream, after its producer). In the backward
each stage fetches its tagged inputs (on a second copy stream, one stage
ahead of the backward's use), recomputes itself from them and
differentiates. A stage input that carries no parked name (the first
layer's input) stays on the device. On the CPU, the park is a copy into a CPU tensor. On CUDA, a pin
that fails raises: nothing falls back to pageable memory or to keeping the
value on the device. Under a mesh a tagged ``DTensor`` parks this device's
shard, and its fetch wraps the shard again with the same placements.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models import remat, runtime
from repro_torch.optim.adamw import tree_items, tree_map_with_path
from repro_torch.pool.backend import HOST_KINDS, pinned_host
from repro_torch.sharding.ops import is_dtensor

OFFLOADABLE_NAMES = ("resid", "attn_out", "mlp_out")

Runner = Callable[[Sequence[remat.Layer], torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------------------
# plain (non-offloading) policies
# ---------------------------------------------------------------------------


class _KeepAll:
    """Every activation kept: the repeat runs as it is."""

    def bind(self) -> Runner:
        return remat.run_layers


@dataclasses.dataclass(frozen=True)
class _Checkpoint:
    """Recompute in the backward from the input kept on the device: the
    whole repeat, or (``per_layer``) each layer from its own input; with
    ``save_mm``, the products without batch dimensions are kept too."""
    per_layer: bool = False
    save_mm: bool = False

    def bind(self) -> Runner:
        from torch.utils.checkpoint import checkpoint
        kw: Dict[str, Any] = {"use_reentrant": False}
        if self.save_mm:
            kw["context_fn"] = _mm_saving_contexts
        if not self.per_layer:
            return lambda layers, h: checkpoint(
                runtime.under_forward_context(
                    functools.partial(remat.run_layers, layers)), h, **kw)
        return lambda layers, h: remat.run_layers(
            [functools.partial(checkpoint,
                               runtime.under_forward_context(layer), **kw)
             for layer in layers], h)


def _mm_saving_contexts():
    from torch.utils.checkpoint import (
        CheckpointPolicy, create_selective_checkpoint_contexts,
    )
    saved = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def remat_policy(name: str = "nothing"):
    """Plain (non-offloading) remat policies for the baseline."""
    if name == "nothing":
        return _Checkpoint()
    if name == "everything":
        return _KeepAll()
    if name == "dots":
        return _Checkpoint(save_mm=True)
    if name == "save_resid":
        return _Checkpoint(per_layer=True)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# activation offload
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OffloadCounts:
    """Bytes the activation offload moved, summed over every forward and
    backward of the policy (``bytes_parked`` device→host in the forward,
    ``bytes_fetched`` host→device in the backward) and the values parked."""
    bytes_parked: int = 0
    bytes_fetched: int = 0
    parked: int = 0


class _Parked:
    """One tagged value in host memory: its copy, the event that says the
    copy has landed (CUDA), the stages whose backward still reads it, the
    device copy the first of them fetched, and, for a ``DTensor`` (whose
    local shard is what is parked), its mesh, placements, shape and
    stride."""

    def __init__(self, host: torch.Tensor, event, like=None) -> None:
        self.host: Optional[torch.Tensor] = host
        self.event = event
        self.like = like
        self.consumers = 0
        self.fetched: Optional[Tuple[torch.Tensor, Any]] = None


class _OffloadScope:
    """The state of one forward under the offload policy: the parked
    values (found again by the identity of the tensor that was tagged) and
    the two copy streams."""

    def __init__(self, names: Tuple[str, ...], counts: OffloadCounts,
                 device: torch.device) -> None:
        self.names = names
        self.counts = counts
        self.device = device
        cuda = device.type == "cuda"
        self.d2h = torch.cuda.Stream(device) if cuda else None
        self.h2d = torch.cuda.Stream(device) if cuda else None
        self._parked: Dict[int, Tuple[weakref.ref, _Parked]] = {}
        self.stages: List[Tuple[Optional[_Parked], ...]] = []

    # -- forward ---------------------------------------------------------
    def lookup(self, x: torch.Tensor) -> Optional[_Parked]:
        hit = self._parked.get(id(x))
        return hit[1] if hit is not None and hit[0]() is x else None

    def park(self, x: torch.Tensor) -> _Parked:
        """Copy ``x`` to host memory (asynchronously on CUDA: the copy
        stream waits for ``x``'s producer, and ``x``'s memory is kept until
        the copy has read it). Of a ``DTensor``, this device's shard."""
        hit = self.lookup(x)
        if hit is not None:
            return hit
        like, local = None, x.detach()
        if is_dtensor(x):
            like = (x.device_mesh, x.placements, x.shape, x.stride())
            local = local.to_local()
        if self.d2h is None:
            parked = _Parked(local.to("cpu", copy=True), None, like)
        else:
            host = torch.empty(local.shape, dtype=local.dtype,
                               pin_memory=True)
            self.d2h.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.d2h):
                host.copy_(local, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.d2h)
            local.record_stream(self.d2h)
            parked = _Parked(host, event, like)
        self._parked[id(x)] = (weakref.ref(x), parked)
        self.counts.bytes_parked += local.numel() * local.element_size()
        self.counts.parked += 1
        return parked

    def tag(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if name in self.names:
            self.park(x)
        return x

    def sublayer(self, name: str, fn: Callable, p: Dict,
                 acts: Sequence[torch.Tensor]):
        leaves, rebuild = _flatten(p)
        handles = tuple(self.lookup(a) for a in acts)
        for h in handles:
            if h is not None:
                h.consumers += 1
        index = len(self.stages)
        self.stages.append(handles)
        out = _Stage.apply(self, index, runtime.under_forward_context(fn),
                           rebuild, len(acts), *acts, *leaves)
        self.tag(out[0] if isinstance(out, tuple) else out, name)
        return out

    # -- backward --------------------------------------------------------
    def prefetch(self, parked: _Parked) -> None:
        """Issue ``parked``'s host→device copy (once)."""
        if parked.fetched is not None or parked.host is None:
            return
        self.counts.bytes_fetched += parked.host.numel() * \
            parked.host.element_size()
        if self.h2d is None:
            parked.fetched = (parked.host.clone(), None)
            return
        self.h2d.wait_event(parked.event)
        with torch.cuda.stream(self.h2d):
            dev = parked.host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.h2d)
        parked.fetched = (dev, event)

    def fetch(self, parked: _Parked) -> torch.Tensor:
        """The device copy of ``parked``, ordered before the backward's
        use on the current stream. The last stage to read it lets go of
        both copies."""
        self.prefetch(parked)
        dev, event = parked.fetched
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            dev.record_stream(current)
        parked.consumers -= 1
        if parked.consumers == 0:
            parked.fetched = parked.host = None
        if parked.like is None:
            return dev
        from torch.distributed.tensor import DTensor
        mesh, placements, shape, stride = parked.like
        return DTensor.from_local(dev, mesh, placements, run_check=False,
                                  shape=shape, stride=stride)

    def prefetch_stage(self, index: int) -> None:
        """Fetch the parked inputs of stage ``index`` ahead of its
        backward (the stage before the one running now)."""
        if index >= 0:
            for parked in self.stages[index]:
                if parked is not None:
                    self.prefetch(parked)


def _flatten(tree: Dict) -> Tuple[List[torch.Tensor], Callable]:
    """Leaves of a nested dict of tensors, and the inverse."""
    paths = [path for path, _ in tree_items(tree)]

    def rebuild(values: Sequence[torch.Tensor]) -> Dict:
        by_path = dict(zip(paths, values))
        return tree_map_with_path(lambda path, _: by_path[path], tree)
    return [x for _, x in tree_items(tree)], rebuild


class _Stage(torch.autograd.Function):
    """One stage of a layer under the offload policy: runs without keeping
    its activations; its backward fetches its parked inputs, recomputes
    the stage from them and differentiates it."""

    @staticmethod
    def forward(ctx, scope: _OffloadScope, index: int, fn: Callable,
                rebuild: Callable, n_acts: int, *tensors: torch.Tensor):
        acts, leaves = tensors[:n_acts], tensors[n_acts:]
        handles = scope.stages[index]
        ctx.scope, ctx.index, ctx.fn, ctx.rebuild = scope, index, fn, rebuild
        ctx.n_acts = n_acts
        # parked inputs are fetched back in the backward; the rest (the
        # first layer's input) stay on the device
        ctx.save_for_backward(*(None if h is not None else a
                                for a, h in zip(acts, handles)), *leaves)
        return fn(rebuild(leaves), *acts)

    @staticmethod
    def backward(ctx, *grads):
        scope, n = ctx.scope, ctx.n_acts
        saved = ctx.saved_tensors
        handles = scope.stages[ctx.index]
        acts = [scope.fetch(h) if h is not None else a
                for a, h in zip(saved[:n], handles)]
        scope.prefetch_stage(ctx.index - 1)
        acts = [a.detach().requires_grad_(True) for a in acts]
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in saved[n:]]
        with torch.enable_grad():
            out = ctx.fn(ctx.rebuild(leaves), *acts)
        outs = out if isinstance(out, tuple) else (out,)
        # an output the recompute made without a graph (a dense FFN's zero
        # aux loss) has no gradient to pass on
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = acts + [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        act_grads = [next(got) for _ in acts]
        leaf_grads = [next(got) if t.requires_grad else None for t in leaves]
        return (None, None, None, None, None, *act_grads, *leaf_grads)


@dataclasses.dataclass
class OffloadPolicy:
    """Tagged values ``names`` parked in host memory across
    forward→backward, everything else recomputed (see module doc).
    ``counts`` sums what every forward bound to it moved."""
    names: Tuple[str, ...] = ("resid",)
    host_kind: Optional[str] = None
    counts: OffloadCounts = dataclasses.field(default_factory=OffloadCounts)

    def bind(self) -> Runner:
        scope: List[_OffloadScope] = []

        def run(layers: Sequence[remat.Layer], h: torch.Tensor):
            if not scope:
                pinned_host(h.device, self.host_kind)   # refuses pageable
                scope.append(_OffloadScope(self.names, self.counts, h.device))
            with remat.tag_scope(scope[0]):
                return remat.run_layers(layers, h)
        return run


def offload_remat_policy(names: Sequence[str] = ("resid",),
                         offload_dst: Optional[str] = None) -> OffloadPolicy:
    """Offload the named activations to host memory instead of keeping
    them on the device or recomputing them. ``offload_dst`` is the host
    memory kind (``pool.backend.pinned_host``: pinned on CUDA, a plain CPU
    copy on the CPU)."""
    if offload_dst not in HOST_KINDS:
        raise ValueError(f"unknown host memory kind {offload_dst!r}")
    unknown = set(names) - set(OFFLOADABLE_NAMES)
    if unknown:
        raise ValueError(f"no tag points named {sorted(unknown)}; the model "
                         f"tags {OFFLOADABLE_NAMES}")
    return OffloadPolicy(tuple(names), offload_dst)
