"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample of
the requests it finished, drawn from the seed with the longest always in
it, goes through the plain reference (``perfbench/reference``) once each:
its prompt followed by the tokens served, in float32. At every served
position the reference's logits say how far the served token's logit lies
below the reference's best. Two numbers come of the gaps: the widest over
the sample (``max_logit_gap``) and their mean over every served token of
it (``mean_logit_gap``). The cell's file names the numbers compared and
their limits: the widest gap where it separates the program from the
control, the mean where routing near-ties (an MoE router deciding in
bfloat16) make the widest gap swing as far as the control reads.

Under ``kv_offload`` the pool has to hold the cache at the configuration's
stated type: every page the run stored, fetched or spilled moves at its
size in that type (``pool_page_bytes_off``, from the pool's counters in
``session.stats()``, limit 0). A page codec below a tier (the program's own
lower-precision path) shrinks what spills and comes back, and fails it;
the logit gaps alone would miss it, since it touches only spilled pages.

The control puts the reference in the program's place one precision down
(float8 products, W8A8, for a bfloat16 configuration): ``check(...,
control=True)`` judges, at the same positions, the token the control puts
first instead of the one served, against the same limits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.harness.stats import Served
from perfbench.reference import dense, moe

#: served tokens a sample holds at least (all finished requests if fewer)
SAMPLE_TOKENS = 200


def reference_logits(config: Dict, params: Dict, seqs,
                     matmul=dense.fp32_matmul) -> List[torch.Tensor]:
    arch = {"dense": dense, "moe": moe}[config["architecture"]]
    return arch.logits(config, params, seqs, matmul)


def finished(served: Sequence[Served], t_close: float) -> List[int]:
    return [i for i, r in enumerate(served)
            if r.done and not r.failed and r.stamps[-1] < t_close]


def draw_sample(served: Sequence[Served], t_close: float, seed: int,
                min_tokens: int = SAMPLE_TOKENS) -> List[int]:
    """Indices of finished requests: the one with the most served tokens
    (its prompt breaking ties), then others in an order drawn from the
    seed, until ``min_tokens`` served tokens are in."""
    done = finished(served, t_close)
    if not done:
        return []
    longest = max(done, key=lambda i: (len(served[i].tokens),
                                       served[i].prompt_len, -i))
    rest = [i for i in done if i != longest]
    order = np.random.default_rng([seed, 1]).permutation(len(rest))
    out, n = [longest], len(served[longest].tokens)
    for j in order:
        if n >= min_tokens:
            break
        out.append(rest[j])
        n += len(served[rest[j]].tokens)
    return out


def sequences(served: Sequence[Served], picks: Sequence[int],
              device: torch.device) -> List[Tuple[torch.Tensor, int, int]]:
    """(prompt ++ served tokens but the last, prompt length, first
    position whose logits predict a served token) for each pick."""
    seqs = []
    for i in picks:
        r = served[i]
        toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
        seqs.append((torch.from_numpy(toks).to(device), r.prompt_len,
                     r.prompt_len - 1))
    return seqs


def _gaps(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best at its position
    (infinite for a token outside the vocabulary)."""
    if int(toks.min()) < 0 or int(toks.max()) >= logits.shape[-1]:
        return torch.full(toks.shape, float("inf"))
    return (logits.max(-1).values
            - logits.gather(-1, toks[:, None].long())[:, 0]).cpu()


def summary(gaps: Sequence[torch.Tensor]) -> Dict[str, float]:
    every = torch.cat(list(gaps))
    return {"max_logit_gap": float(every.max()),
            "mean_logit_gap": float(every.mean())}


def served_gaps(ref: Sequence[torch.Tensor], served: Sequence[Served],
                picks: Sequence[int]) -> Dict[str, float]:
    """The served tokens' gaps below the reference's best."""
    return summary([_gaps(logits, torch.tensor(served[i].tokens,
                                                device=logits.device))
                    for logits, i in zip(ref, picks)])


def chosen_gaps(ref: Sequence[torch.Tensor],
                other: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The gaps of ``other``'s first choices below the reference's best."""
    return summary([_gaps(r, o.argmax(-1)) for r, o in zip(ref, other)])


def pool_page_bytes_off(config: Dict, layout: Dict,
                        pool: Optional[Dict]) -> float:
    """How many bytes the pool's moves (pages stored, fetched and spilled)
    differ from as many pages at their size in the configuration's cache
    type: one layer's keys or values of one row, ``max_seq x kv heads x
    head_dim`` elements. 0 when every page moved at its stated type."""
    if not pool:
        return float("inf")
    page = (layout["max_seq"] * config["num_key_value_heads"]
            * config["head_dim"]
            * torch.finfo(getattr(torch, config["cache_dtype"])).bits // 8)
    moved = pool["puts"] + pool["gets"] + pool["evictions"]
    wire = pool["bytes_stored"] + pool["bytes_fetched"] + pool["bytes_evicted"]
    return float(abs(wire - moved * page))


def check(config: Dict, layout: Dict, params: Dict, served: Sequence[Served],
          t_close: float, seed: int, limits: Dict[str, float],
          device: torch.device, *, pool: Optional[Dict] = None,
          control: bool = False
          ) -> Tuple[bool, Dict[str, Dict[str, float]], Dict[str, float]]:
    """(correct, {number compared: {value, limit}}, the sample's counts and
    every number, compared or not). ``pool`` is the pool's counters at the
    run's end; ``control`` judges the float8 control's first choices in
    place of the served tokens."""
    picks = draw_sample(served, t_close, seed)
    info: Dict[str, float] = {
        "sample_requests": len(picks),
        "sample_tokens": sum(len(served[i].tokens) for i in picks)}
    values: Dict[str, float] = {"max_logit_gap": float("inf"),
                                "mean_logit_gap": float("inf")}
    if picks:
        seqs = sequences(served, picks, device)
        ref = reference_logits(config, params, seqs)
        if control:
            values = chosen_gaps(ref, reference_logits(config, params, seqs,
                                                       dense.fp8_matmul))
        else:
            values = served_gaps(ref, served, picks)
    if "pool_page_bytes_off" in limits:
        if control:         # the pool's counters are the program's
            limits = {k: v for k, v in limits.items()
                      if k != "pool_page_bytes_off"}
        else:
            values["pool_page_bytes_off"] = pool_page_bytes_off(
                config, layout, pool)
    info.update(values)
    numbers = {name: {"value": values[name], "limit": limit}
               for name, limit in limits.items()}
    return all(n["value"] <= n["limit"] for n in numbers.values()), \
        numbers, info
