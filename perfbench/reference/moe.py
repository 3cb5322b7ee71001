"""Plain PyTorch reference of a top-k routed mixture-of-experts decoder as
granite-3.0-3b-a800m describes it (GraniteMoe: the dense decoder of
``dense`` with each MLP replaced by 40 SwiGLU experts, 8 per token, chosen
by the softmax router's largest probabilities and weighted by them,
renormalised over the 8).

One departure from the published model is the program's, and followed
here because the configuration's file states it (``moe_capacity_factor``):
within one call of the layer an expert keeps at most ``capacity(n)`` of the
``n`` tokens routed to it, the earliest first, and a dropped assignment adds
nothing. A whole prompt is one call (``n`` = its length); every later token
is decoded in a batch of ``max_batch`` rows, whose capacity is never below
``max_batch``, so no generated position drops. The routing and the drops are
worked out here again from the weights and tokens.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import dense


def capacity(n: int, config: Dict) -> int:
    """Assignments an expert keeps of ``n`` tokens: the port's rule,
    ``ceil(n * k / E * factor)`` padded up to a multiple of 8, at least 8."""
    cap = math.ceil(n * config["num_experts_per_tok"]
                    / config["num_local_experts"]
                    * config["moe_capacity_factor"])
    return max(8, -(-cap // 8) * 8)


def routed_ffn(config: Dict, p: Dict, x: torch.Tensor, prompt_len: int,
               matmul: dense.Matmul) -> torch.Tensor:
    """x (T, d): rows ``[0, prompt_len)`` were one call of the layer, each
    later row a call of its own batch."""
    f = p["ffn"]
    k, e = config["num_experts_per_tok"], config["num_local_experts"]
    probs = torch.softmax(x @ f["router"], dim=-1)                 # (T, E)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True)
    keep = torch.ones_like(top_e, dtype=torch.bool)
    cap = capacity(prompt_len, config)
    pe = top_e[:prompt_len]
    for j in range(e):
        hits = (pe == j).nonzero()          # (token, slot), tokens in order
        if hits.shape[0] > cap:
            drop = hits[cap:]
            keep[drop[:, 0], drop[:, 1]] = False
    out = torch.zeros_like(x)
    for j in range(e):
        rows, slots = ((top_e == j) & keep).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(matmul(xe, f["w_gate"][j])) * matmul(xe, f["w_up"][j])
        out.index_add_(0, rows, matmul(h, f["w_down"][j])
                       * top_w[rows, slots, None])
    return out


def logits(config: Dict, params: Dict,
           seqs: Sequence[Tuple[torch.Tensor, int, int]],
           matmul: dense.Matmul = dense.fp32_matmul) -> List[torch.Tensor]:
    """As ``dense.logits``, with the routed experts as the FFN."""
    return dense.logits(config, params, seqs, matmul, ffn=routed_ffn)
