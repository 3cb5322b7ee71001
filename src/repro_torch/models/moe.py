"""Top-k token-choice Mixture-of-Experts with sort-based capacity dispatch
(the counterpart of ``repro.models.moe``).

Assignments (token, expert) are sorted by expert id (a stable sort, as
the reference's ``jnp.argsort(..., stable=True)``), ranked within their
expert, and the first ``capacity`` of each expert fill a dense
``(E·C, D)`` buffer; the rest are dropped and contribute exactly zero.
The experts run as batched SwiGLU products over the buffer, and each
token's output is the weighted sum of its kept assignments.

Both data movements are gathers, so they are deterministic on the card:

- the dispatch reads each buffer row from the token that fills it (an
  empty row reads a zero row); its backward gathers each token's
  gradient back from its ``k`` buffer rows and adds them in a fixed
  order, where the plain ``index`` backward would scatter-add with
  atomics;
- the combine gathers each token's ``k`` expert outputs (a dropped one
  reads the zero sentinel row ``E·C``) and adds them one after another in
  the order of increasing expert id, in the activations' type from zero:
  the order in which the reference's scatter-add meets them.

Under an active mesh and rule-set (``sharding.rules.axis_rules``)
``moe_ffn`` runs :func:`_moe_ffn_sharded`, the reference's ``shard_map``
as a ``local_map``: each data shard routes and dispatches its own rows
(a global ``argsort`` has no ``DTensor`` strategy, and would replicate the
token buffer), the experts' products run on their tensor-parallel
columns, and the partial outputs are summed over those ranks. The sort,
the index scatters of the dispatch and the gathers of the combine all run
on local tensors there; nothing in this module hands one of them a
``DTensor``. Otherwise it runs :func:`_moe_ffn_local`.

Load-balancing auxiliary loss: ``E * sum_e(fraction_e * router_prob_e)``
times ``router_aux_weight``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init
from repro_torch.sharding.rules import (
    constrain,
    current_mesh,
    current_rules,
    mesh_axis_sizes,
)


def init_moe_params(cfg: ModelConfig, dtype: torch.dtype,
                    device: torch.device, generator: torch.Generator,
                    stack: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """The router is fp32 whatever ``dtype`` is, as in the reference; the
    experts are stacked ``(E, D, F)`` / ``(E, F, D)`` with fan-in ``D`` /
    ``F``."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    st, ax = tuple(stack), len(stack)
    return {
        "router": dense_init(st + (d, e), torch.float32, device, generator,
                             ax),
        "w_gate": dense_init(st + (e, d, f), dtype, device, generator,
                             ax + 1),
        "w_up": dense_init(st + (e, d, f), dtype, device, generator, ax + 1),
        "w_down": dense_init(st + (e, f, d), dtype, device, generator,
                             ax + 1),
    }


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    cap = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    # padded to a multiple of 8, at least 8
    return max(8, -(-cap // 8) * 8)


class Routing(NamedTuple):
    """The router's decisions for ``n`` tokens, in the reference's terms
    where it has them: ``dest``/``keep`` are in the order that sorts the
    ``n·k`` assignments by expert (``dest`` is the sentinel ``E·C`` where
    ``keep`` is false). ``token_dest`` and ``token_w`` hold each token's
    ``k`` buffer rows and renormalized weights in the order of increasing
    expert id; ``row_token`` the token that fills each buffer row (``n``
    for an empty row)."""
    capacity: int
    aux: torch.Tensor          # () fp32
    top_e: torch.Tensor        # (n, k) int64, by falling probability
    dest: torch.Tensor         # (n·k,)
    keep: torch.Tensor         # (n·k,) bool
    token_dest: torch.Tensor   # (n, k)
    token_w: torch.Tensor      # (n, k) fp32
    row_token: torch.Tensor    # (E·C,)


def route(cfg: ModelConfig, router: torch.Tensor,
          xf: torch.Tensor) -> Routing:
    """Router logits in fp32, softmax, top-k (ties to the lower expert
    index, as ``jax.lax.top_k``), renormalized weights, the auxiliary
    loss, and the capacity-bounded sort-based dispatch of ``xf`` (n, D)."""
    m = cfg.moe
    n = xf.shape[0]
    e, k = m.n_experts, m.top_k
    cap = expert_capacity(n, cfg)
    dev = xf.device
    probs = torch.softmax(xf.float() @ router, dim=-1)          # (n, E)
    # a stable descending sort keeps the lower index first among equal
    # probabilities, as lax.top_k does
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    # assignments per expert: an integer scatter-add (exact in any order,
    # and of a fixed size: ``bincount`` would read its size back from the
    # device)
    flat_e = top_e.reshape(n * k)
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    frac = counts.float() / n
    aux = e * torch.sum(frac * torch.mean(probs, dim=0)) * m.router_aux_weight

    order = torch.argsort(flat_e, stable=True)                   # by expert
    se = flat_e[order]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n * k, device=dev) - starts[se]
    keep = rank < cap
    dest = torch.where(keep, se * cap + rank, e * cap)
    # each assignment's buffer row in its original (token, slot) place;
    # a token's experts are distinct, so sorting its rows by their place
    # in ``order`` lists them by increasing expert id
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=dev)
    by_expert = torch.sort(inv.reshape(n, k), dim=1).values      # (n, k)
    token_dest = dest[by_expert]
    token_w = top_w.reshape(n * k)[order][by_expert]
    row_token = torch.full((e * cap + 1,), n, dtype=torch.long, device=dev)
    row_token[dest] = torch.div(order, k, rounding_mode="floor")
    return Routing(cap, aux, top_e, dest, keep, token_dest, token_w,
                   row_token[:e * cap])


def _gather_rows_summed(rows: torch.Tensor, index: torch.Tensor,
                        weights=None) -> torch.Tensor:
    """``sum_i rows[index[:, i]] (* weights[:, i])`` over the columns of
    ``index`` (n, k), added one after another from zero in ``rows``' type:
    a fixed order on every device."""
    out = torch.zeros((index.shape[0], rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for i in range(index.shape[1]):
        r = rows[index[:, i]]
        if weights is not None:
            r = r * weights[:, i:i + 1]
        out = out + r
    return out


class _Dispatch(torch.autograd.Function):
    """``buf = [x; 0][row_token]``; the backward gathers each token's
    gradient from its ``k`` buffer rows (``token_dest``, the sentinel row
    reading zero) instead of scatter-adding."""

    @staticmethod
    def forward(ctx, xf: torch.Tensor, row_token: torch.Tensor,
                token_dest: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(token_dest)
        return torch.cat([xf, xf.new_zeros((1, xf.shape[1]))])[row_token]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        token_dest, = ctx.saved_tensors
        padded = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        return _gather_rows_summed(padded, token_dest), None, None


def moe_ffn(cfg: ModelConfig, p: Dict,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss): :func:`_moe_ffn_sharded` under an
    active mesh and rule-set, :func:`_moe_ffn_local` otherwise."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is not None and rules is not None:
        return _moe_ffn_sharded(cfg, p, x, mesh, rules)
    return _moe_ffn_local(cfg, p, x)


def _mesh_axes(rules, name: str, sizes: Dict[str, int],
               dim: int) -> Tuple[str, ...]:
    """The mesh axes a rule maps ``name`` to, kept where the axis has more
    than one device and divides ``dim``."""
    axes = rules.get(name) or ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if sizes.get(a, 1) > 1 and dim % sizes[a] == 0)


def _moe_ffn_sharded(cfg: ModelConfig, p: Dict, x: torch.Tensor, mesh,
                     rules) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch per data shard (the reference's ``shard_map``).

    ``dp``: the mesh axes of ``rules["batch"]``, ``tp``: those of
    ``rules["expert_mlp"]``, each kept where its size is above 1 and
    divides the batch / ``d_ff_expert``. Each data shard runs
    :func:`_moe_ffn_local` on its rows, with capacity from its **local**
    token count; the expert products run on ``d_ff_expert / |tp|``
    columns, ``out`` is all-reduced (sum) over ``tp`` and ``aux``
    averaged over ``dp``. No ``constrain`` runs inside (the reference's
    ``manual=True``). On a one-device mesh this is :func:`_moe_ffn_local`
    on the whole tensors, bit for bit."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    sizes = mesh_axis_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    dp = _mesh_axes(rules, "batch", sizes, x.shape[0])
    tp = _mesh_axes(rules, "expert_mlp", sizes, cfg.moe.d_ff_expert)
    dp_dims = [names.index(a) for a in dp]
    tp_dims = [names.index(a) for a in tp]

    def placed(dims, shard):
        return tuple(shard if i in dims else Replicate()
                     for i in range(len(names)))

    rep = placed((), None)
    x_pl = placed(dp_dims, Shard(0))
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]

    def local(xb, router, wg, wu, wd):
        pl = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
        out, aux = _moe_ffn_local(cfg, pl, xb, manual=True)
        for i in tp_dims:
            out = _AllReduceSum.apply(out, (mesh, i))
        if dp_dims:
            for i in dp_dims:
                aux = _AllReduceSum.apply(aux, (mesh, i))
            aux = aux / n_dp
        return out, aux

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    # x's gradient from each tensor-parallel rank is that rank's partial
    x_grad = tuple(Partial() if i in tp_dims else x_pl[i]
                   for i in range(len(names)))
    w_pl = placed(tp_dims, Shard(2))
    wd_pl = placed(tp_dims, Shard(1))
    return local_map(
        local, out_placements=(x_pl, rep),
        in_placements=(x_pl, rep, w_pl, w_pl, wd_pl),
        in_grad_placements=(x_grad, rep, w_pl, w_pl, wd_pl),
        device_mesh=mesh, redistribute_inputs=True,
    )(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])


class _AllReduceSum(torch.autograd.Function):
    """A sum over one mesh dim of partial results whose cotangent is
    replicated over it: the backward hands each rank the cotangent as it
    is (Megatron's "g")."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def _moe_ffn_local(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                   manual: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss). Capacity comes from ``n = B·S`` of
    ``x`` as given (padded buckets, empty slots and chunks included), as in
    the reference. ``manual`` (inside :func:`_moe_ffn_sharded`) skips the
    sharding constraints."""
    b, s, d = x.shape
    e = cfg.moe.n_experts
    xf = x.reshape(b * s, d)
    r = route(cfg, p["router"], xf)
    ein = _Dispatch.apply(xf, r.row_token, r.token_dest)
    ein = ein.reshape(e, r.capacity, d)
    if not manual:
        ein = constrain(ein, (None, None, "embed_act"))
    h = F.silu(torch.bmm(ein, p["w_gate"])) * torch.bmm(ein, p["w_up"])
    if not manual:
        h = constrain(h, ("experts", None, "expert_mlp"))
    eout = torch.bmm(h, p["w_down"])                              # (E, C, D)
    eflat = torch.cat([eout.reshape(e * r.capacity, d),
                       eout.new_zeros((1, d))])
    w = r.token_w.to(eout.dtype)
    out = _gather_rows_summed(eflat, r.token_dest, w)
    return out.to(x.dtype).reshape(b, s, d), r.aux
