"""The one traffic generator: turns a mix file (``perfbench/mixes/<name>.json``)
and a rate into an open-loop arrival schedule.

Every seed gets the same work in another order. The schedule has two
segments, the lead-in and the window, and each is filled on its own: its
``n = round(rate x seconds)`` inter-arrival gaps are the exponential
distribution's quantiles at ``(i + 0.5) / n`` (a Poisson process's gaps,
stratified) scaled to span the segment exactly, and its prompt and output
lengths the lognormal's quantiles at the same points, clipped to the mix's
range. The seed draws only the order of each list, independently, and the
token ids. So two seeds send the window the same requests in another
order, and the run-to-run spread is that of the system, not of the draw.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of the schedule: due ``due_s`` seconds after the lead-in
    opens."""

    due_s: float
    prompt: np.ndarray          # (S,) int32 token ids
    max_new_tokens: int


def lognormal_quantiles(spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths: the lognormal (``median``, ``sigma``) at the
    quantiles ``(i + 0.5) / n``, rounded and clipped to [min, max]."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    vals = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` gaps of a Poisson process at ``rate`` per second, as the
    exponential's quantiles ``(i + 0.5) / n``."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def _segment(mix: Dict, rate: float, seconds: float, offset: float,
             rng: np.random.Generator, vocab_size: int) -> List[Arrival]:
    n = max(1, int(round(rate * seconds)))
    gaps = rng.permutation(exponential_gaps(rate, n))
    gaps *= seconds / gaps.sum()
    prompts = rng.permutation(lognormal_quantiles(mix["prompt_tokens"], n))
    outputs = rng.permutation(lognormal_quantiles(mix["output_tokens"], n))
    due = offset + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [Arrival(float(due[i]),
                    rng.integers(0, vocab_size, size=int(prompts[i]),
                                 dtype=np.int32),
                    int(outputs[i]))
            for i in range(n)]


def schedule(mix: Dict, rate: float, seconds: float, seed: int,
             vocab_size: int) -> List[Arrival]:
    """The arrivals of a run: ``mix["lead_in_s"]`` seconds of lead-in, then
    the ``seconds`` of the window, at ``rate`` requests a second."""
    if mix.get("arrivals") != "poisson":
        raise ValueError(f"mix {mix['name']!r}: arrivals "
                         f"{mix.get('arrivals')!r} (only 'poisson')")
    if mix.get("token_ids") != "uniform" or mix.get("shared_prefix_tokens"):
        raise ValueError(f"mix {mix['name']!r}: only uniform, unshared "
                         "token ids")
    rng = np.random.default_rng(seed)
    lead = mix["lead_in_s"]
    out = _segment(mix, rate, lead, 0.0, rng, vocab_size) if lead > 0 else []
    return out + _segment(mix, rate, seconds, lead, rng, vocab_size)
