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

The reference's ``_moe_ffn_sharded`` (the dispatch inside ``shard_map``
over a device mesh, with tensor-parallel experts) waits for the port's
sharding tooling; ``moe_ffn`` here is the reference's ``_moe_ffn_local``.

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
    """x: (B, S, D) -> (out, aux_loss). Capacity comes from ``n = B·S`` of
    ``x`` as given (padded buckets, empty slots and chunks included), as in
    the reference."""
    b, s, d = x.shape
    e = cfg.moe.n_experts
    xf = x.reshape(b * s, d)
    r = route(cfg, p["router"], xf)
    ein = _Dispatch.apply(xf, r.row_token, r.token_dest)
    ein = ein.reshape(e, r.capacity, d)
    h = F.silu(torch.bmm(ein, p["w_gate"])) * torch.bmm(ein, p["w_up"])
    eout = torch.bmm(h, p["w_down"])                              # (E, C, D)
    eflat = torch.cat([eout.reshape(e * r.capacity, d),
                       eout.new_zeros((1, d))])
    w = r.token_w.to(eout.dtype)
    out = _gather_rows_summed(eflat, r.token_dest, w)
    return out.to(x.dtype).reshape(b, s, d), r.aux
