"""Train-step builder: loss → grads → AdamW, with a selectable memory
policy (the counterpart of ``repro.training.step``).

Memory policies map to the paper's training case study (§5.1):

- ``remat="none"``      — keep all activations (memory-hungry baseline)
- ``remat="full"``      — recompute everything (each repeat of a layer
                          pattern from its input)
- ``remat="offload"``   — HyperOffload: park the tagged activations
                          ("resid"/"attn_out"/"mlp_out") in pinned host
                          memory instead of recomputing them or keeping them
                          on the device (``offload.policies``)
- ``offload_opt_state`` — the AdamW moments live in pinned host memory
                          between steps and stream through the device one
                          (leaf, layer) slice at a time during the update
                          (``offload.optstate``)

On a CUDA device the step runs the model under
``use_attention_impl("plain")``: the port's attention and SSD kernels are
forward-only (they refuse inputs that require grad) and the reference
trains on its plain XLA path too, so no kernel lies on this path.

Gradients: every stacked parameter is differentiated layer by layer (a
per-layer view of it is the autograd leaf), and each leaf's gradient
accumulates in place into one buffer of the parameter's shape and dtype,
made before the forward; the optimizer then walks the same (leaf, layer)
slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model
from repro_torch.models.runtime import use_attention_impl
from repro_torch.offload import optstate
from repro_torch.offload.policies import (
    OFFLOADABLE_NAMES, OffloadPolicy, offload_remat_policy, remat_policy,
)
from repro_torch.optim.adamw import (
    AdamWState, adamw_init, adamw_update, is_stacked, tree_items, tree_map,
    tree_map_with_path,
)
from repro_torch.optim.schedule import cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    remat: str = "none"              # none | full | offload
    offload_opt_state: bool = False
    # memory kind for parked moments and activations (None = pinned on
    # CUDA, plain CPU memory on the CPU); comes from
    # OffloadConfig.host_memory_kind when built through the session
    host_kind: Optional[str] = None
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # gradient accumulation: split the global batch into N microbatches run
    # sequentially — activation memory scales with batch/N while the
    # optimizer sees the full-batch gradient (composes with offload remat)
    grad_accum: int = 1


def _policy(ts: TrainStepConfig):
    if ts.remat == "none":
        return None
    if ts.remat == "full":
        return remat_policy("nothing")
    if ts.remat == "offload":
        return offload_remat_policy(OFFLOADABLE_NAMES, ts.host_kind)
    raise ValueError(ts.remat)


def _loss_and_grads(model: Model, policy, params: Any, batch: Dict
                    ) -> Tuple[torch.Tensor, Any]:
    """(fp32 loss, grads) for one batch: the grads tree mirrors ``params``,
    in the parameters' dtypes."""
    grads = tree_map(torch.zeros_like, params)
    grad_at = dict(tree_items(grads))
    leaves = []

    def leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        v = p.detach().requires_grad_(True)
        v.grad = g
        leaves.append(v)
        return v

    def views(path: Tuple, p: torch.Tensor):
        g = grad_at[path]
        if is_stacked(path):
            return [leaf(pr, gr) for pr, gr in zip(p.unbind(0), g.unbind(0))]
        return leaf(p, g)

    diff = tree_map_with_path(views, params)
    loss = model.loss(diff, batch, remat_policy=policy)
    loss.backward()
    for v in leaves:   # the buffers keep the gradients; drop the views
        v.grad = None
    return loss.detach(), grads


def make_train_step(model: Model, ts: TrainStepConfig = TrainStepConfig(),
                    jit: bool = True) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``grad_norm`` and ``lr`` (0-dim fp32
    tensors). The parameters and the moments are updated in place.

    ``jit`` is the reference's switch for ``jax.jit``; it has no
    counterpart here (the step is not compiled) and is accepted so the
    session's calls match. The returned function carries ``counts``: the
    activation offload's ``OffloadCounts`` (or None) and the streamed
    moments' ``MomentCounts`` (or None), summed over its calls."""
    del jit
    policy = _policy(ts)
    moments = optstate.MomentCounts() if ts.offload_opt_state else None

    def loss_and_grads(params, batch):
        if ts.grad_accum == 1:
            return _loss_and_grads(model, policy, params, batch)
        n = ts.grad_accum
        loss_sum = torch.zeros((), dtype=torch.float32)
        grad_sum = None
        for i in range(n):
            mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, grads = _loss_and_grads(model, policy, params, mb)
            loss_sum = loss_sum.to(loss.device) + loss
            if grad_sum is None:
                grad_sum = tree_map(lambda g: g.float(), grads)
            else:
                for (_, acc), (_, g) in zip(tree_items(grad_sum),
                                            tree_items(grads)):
                    acc.add_(g.float())
        inv = 1.0 / n
        return loss_sum * inv, tree_map(lambda g: g * inv, grad_sum)

    def step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor]):
        with use_attention_impl("plain"):
            loss, grads = loss_and_grads(params, batch)
        lr = cosine_schedule(opt_state.step + 1, peak_lr=ts.peak_lr,
                             warmup=ts.warmup, total=ts.total_steps)
        stream = None
        if ts.offload_opt_state:
            def stream(work, clip, h):
                optstate.streamed_update(work, clip, h, moments)
        params, opt_state, gn = adamw_update(
            grads, opt_state, params, lr, b1=ts.b1, b2=ts.b2,
            weight_decay=ts.weight_decay, grad_clip=ts.grad_clip,
            stream=stream)
        return params, opt_state, {"loss": loss, "grad_norm": gn, "lr": lr}

    step.counts = {"activations": policy.counts
                   if isinstance(policy, OffloadPolicy) else None,
                   "moments": moments}
    return step


def init_train_state(model: Model, generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.float32,
                     ts: TrainStepConfig = TrainStepConfig(),
                     device: DeviceLike = None) -> Tuple[Any, AdamWState]:
    """Random parameters (``Model.init``) and zero AdamW moments; with
    ``offload_opt_state`` the moments are made in host memory (pinned on
    CUDA)."""
    dev = resolve_device(device)
    params = model.init(generator, dtype, dev)
    if not ts.offload_opt_state:
        return params, adamw_init(params)
    zeros = lambda: optstate.host_zeros_like(params, dev, ts.host_kind)
    return params, AdamWState(step=torch.zeros((), dtype=torch.int32),
                              mu=zeros(), nu=zeros())
