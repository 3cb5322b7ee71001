"""End-to-end metric arithmetic over the window's token stamps.

A request's stamps are the host times at which the scheduler steps that
emitted its tokens returned (each step ends on a host copy of the sampled
tokens, so a stamp follows the device work that made the token)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Served:
    """What the window saw of one request."""

    due: float                     # host time it was due
    submitted: Optional[float]     # host time it was submitted
    prompt_len: int
    max_new_tokens: int
    stamps: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    failed: bool = False
    prompt: Optional[np.ndarray] = None

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between the closest ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def window_metrics(served: Sequence[Served], t_open: float,
                   t_close: float) -> Dict[str, float]:
    """The end-to-end numbers of one window, and the counts beside them."""
    w = t_close - t_open
    inside = lambda t: t_open <= t < t_close        # noqa: E731
    tokens = sum(1 for r in served for t in r.stamps if inside(t))
    due = [r for r in served if inside(r.due)]
    ttft, censored = [], 0
    for r in due:
        if r.stamps and r.stamps[0] < t_close:
            ttft.append(r.stamps[0] - r.due)
        else:                       # no first token by the close
            ttft.append(t_close - r.due)
            censored += 1
    gaps = [b - a for r in served for a, b in zip(r.stamps, r.stamps[1:])
            if inside(a) and inside(b)]
    late = [r.submitted - r.due for r in due if r.submitted is not None]
    out = {
        "window_s": w,
        "tokens": tokens,
        "output_tok_s": tokens / w,
        "requests_due": len(due),
        "requests_started": sum(1 for r in due if r.stamps
                                and r.stamps[0] < t_close),
        "requests_completed": sum(1 for r in due if r.done
                                  and r.stamps[-1] < t_close),
        "requests_censored": censored,
        "requests_failed": sum(1 for r in due if r.failed),
        "itl_gaps": len(gaps),
    }
    if ttft:
        out["ttft_p90_ms"] = 1e3 * percentile(ttft, 90)
        out["ttft_p50_ms"] = 1e3 * percentile(ttft, 50)
    if gaps:
        out["itl_p95_ms"] = 1e3 * percentile(gaps, 95)
        out["itl_p50_ms"] = 1e3 * percentile(gaps, 50)
    if late:
        out["submit_late_p50_ms"] = 1e3 * percentile(late, 50)
        out["submit_late_max_ms"] = 1e3 * max(late)
    return out


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, the quartiles as ``statistics.quantiles(values,
    n=4)`` gives them."""
    import statistics
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
