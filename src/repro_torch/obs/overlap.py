"""Transfer-overlap analysis: the paper's latency-hiding claim, measured
(the port's copy of ``repro.obs.overlap``).

HyperOffload's thesis is that graph-driven scheduling hides remote-memory
latency behind compute-intensive regions. The aggregate counters
(`TransferStats.waits_overlapped` / `waits_blocked` / `blocked_s`) say how
often a consumer found its transfer done; this analyzer reconstructs the
*time decomposition* from the trace:

- every transfer emits a ``transfer`` span (execution start → complete —
  queue time is excluded, so it can't masquerade as hidden time; it shows
  up as ``transfer.backpressure`` instead) carrying its handle ``seq`` and
  source/destination tiers. On CUDA the span is the copy's own interval on
  the copy stream, from two timing events mapped onto the host clock
  (``pool.transfer.CopyClock``), so neither the copy stream's wait for the
  submitter's compute nor the worker thread's wait for its event counts as
  transfer time; on the CPU it is the host interval of the transfer's
  thunk. A job that reads several tiers emits one span per tier, all with
  its ``seq`` and each with its ``pages``: its copy time is theirs summed,
  and it counts as their pages' transfers;
- every first consumer wait emits a ``transfer.wait`` span (wait start →
  wait end) with ``hit`` = the transfer was already done.

For one transfer, **exposed** time is the part of its copy its wait
blocked on: the wait's duration when the wait blocked, but never more
than the transfer span (a blocked wait also covers what the copy waited
for: the submitter's work, a free worker, the queue). **Hidden** time is
the rest of the span — transfer work that ran under compute/host work the
pipeline was doing anyway. A transfer no consumer ever waited on
(engine-internal retirement) is fully hidden.

``hidden_fraction = hidden / (hidden + exposed)`` is the direct
measurement of the claim: 1.0 means every transferred byte moved behind
something else; 0.0 means the pipeline is synchronous in disguise.

The transfer engine keeps the same decomposition as counters, taken at
each first wait from the same two intervals (``TransferStats.hidden_s``/
``exposed_s``, reported by its ``clock()`` with telemetry on).

The decomposition is broken out per source→destination tier pair and per
scheduler step (transfers attributed to the ``sched/step`` span their wait
fell in), and ``validate`` cross-checks it against the counters
`TransferStats` already keeps — trace and counters are independent
recordings of the same waits, so disagreement means instrumentation rot.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.obs.trace import TraceEvent, Tracer

__all__ = ["OverlapAnalyzer"]

#: trace schema names this analyzer (and the checker) key on
TRANSFER_SPAN = "transfer"
WAIT_SPAN = "transfer.wait"
STEP_SPAN = "step"
SCHED_CAT = "sched"
TRANSFER_CAT = "transfer"


@dataclass
class _Transfer:
    seq: int
    issue: float
    complete: float
    #: by tier pair (one span per tier a job reads): [seconds, pages]
    parts: Dict[str, List[float]] = field(default_factory=dict)
    wait_start: Optional[float] = None
    wait_end: Optional[float] = None
    hit: Optional[bool] = None    # wait found it done (None = never waited)

    @property
    def copy_s(self) -> float:
        return sum(seconds for seconds, _ in self.parts.values())

    @property
    def exposed_s(self) -> float:
        if self.hit is False:
            return min(max(self.wait_end - self.wait_start, 0.0),
                       self.copy_s)
        return 0.0

    @property
    def hidden_s(self) -> float:
        return max(self.copy_s - self.exposed_s, 0.0)


def _bucket(into: Dict[str, Any], t: _Transfer, pages: int,
            share: float = 1.0) -> None:
    into["transfers"] += pages
    into["hidden_s"] += share * t.hidden_s
    into["exposed_s"] += share * t.exposed_s
    if t.hit is True:
        into["waits_overlapped"] += 1
    elif t.hit is False:
        into["waits_blocked"] += 1


def _new_bucket() -> Dict[str, Any]:
    return {"transfers": 0, "hidden_s": 0.0, "exposed_s": 0.0,
            "waits_overlapped": 0, "waits_blocked": 0}


def _finish_bucket(b: Dict[str, Any]) -> Dict[str, Any]:
    total = b["hidden_s"] + b["exposed_s"]
    b["hidden_fraction"] = (b["hidden_s"] / total) if total > 0 else None
    return b


class OverlapAnalyzer:
    """Post-process a trace into the hidden/exposed transfer-time
    decomposition (see module doc)."""

    def __init__(self, events: Iterable[TraceEvent]) -> None:
        self.transfers: Dict[int, _Transfer] = {}
        waits: List[Tuple[int, float, float, bool]] = []
        self.steps: List[Tuple[float, float, int]] = []   # (t0, t1, step)
        for ev in events:
            if ev.cat == TRANSFER_CAT and ev.name == TRANSFER_SPAN:
                seq = int(ev.args["seq"])
                t = self.transfers.setdefault(
                    seq, _Transfer(seq=seq, issue=ev.ts, complete=ev.end))
                t.issue, t.complete = min(t.issue, ev.ts), \
                    max(t.complete, ev.end)
                pair = (f"{ev.args.get('src') or '?'}->"
                        f"{ev.args.get('dst') or '?'}")
                part = t.parts.setdefault(pair, [0.0, 0])
                part[0] += max(ev.end - ev.ts, 0.0)
                part[1] += int(ev.args.get("pages", 1))
            elif ev.cat == TRANSFER_CAT and ev.name == WAIT_SPAN:
                waits.append((int(ev.args["seq"]), ev.ts, ev.end,
                              bool(ev.args.get("hit"))))
            elif ev.cat == SCHED_CAT and ev.name == STEP_SPAN:
                self.steps.append((ev.ts, ev.end,
                                   int(ev.args.get("step", len(self.steps)))))
        self.steps.sort()
        # waits whose transfer span fell off the ring are dropped (a ring
        # keeps newest events; a wait always outlives its transfer span's
        # emission, so the orphan is the transfer, not the wait)
        self.orphan_waits = 0
        for seq, t0, t1, hit in waits:
            t = self.transfers.get(seq)
            if t is None:
                self.orphan_waits += 1
                continue
            t.wait_start, t.wait_end, t.hit = t0, t1, hit

    @classmethod
    def from_tracer(cls, tracer: Tracer) -> "OverlapAnalyzer":
        return cls(tracer.events())

    # ------------------------------------------------------------------
    def _step_of(self, t: _Transfer) -> Optional[int]:
        """The scheduler step whose span contains the transfer's wait
        (where exposure is charged); un-waited transfers attribute by
        their issue time."""
        at = t.wait_start if t.wait_start is not None else t.issue
        i = bisect.bisect_right(self.steps, (at, float("inf"), 1 << 62)) - 1
        if i >= 0 and self.steps[i][0] <= at <= self.steps[i][1]:
            return self.steps[i][2]
        return None

    def report(self) -> Dict[str, Any]:
        """The full decomposition: totals, per tier pair, per step."""
        total = _new_bucket()
        by_tier: Dict[str, Dict[str, Any]] = {}
        by_step: Dict[int, Dict[str, Any]] = {}
        inflight_s = 0.0
        for t in self.transfers.values():
            pages = sum(n for _, n in t.parts.values())
            _bucket(total, t, pages)
            inflight_s += t.copy_s
            for pair, (seconds, n) in t.parts.items():
                # a job's hidden and exposed time split by its tiers' copies
                share = seconds / t.copy_s if t.copy_s > 0 \
                    else 1.0 / len(t.parts)
                _bucket(by_tier.setdefault(pair, _new_bucket()), t, n, share)
            step = self._step_of(t)
            if step is not None:
                _bucket(by_step.setdefault(step, _new_bucket()), t, pages)
        out = _finish_bucket(total)
        out["inflight_s"] = inflight_s
        out["orphan_waits"] = self.orphan_waits
        out["by_tier"] = {k: _finish_bucket(v)
                          for k, v in sorted(by_tier.items())}
        out["by_step"] = [dict(step=k, **_finish_bucket(v))
                          for k, v in sorted(by_step.items())]
        return out

    def validate(self, transfer_stats: Mapping[str, float], *,
                 tol_s: float = 5e-3,
                 clock: Optional[Mapping[str, Any]] = None) -> List[str]:
        """Cross-check the trace decomposition against a
        ``TransferStats.snapshot()``: wait counts must match exactly and
        the trace's exposed time must equal the engine's within ``tol_s``
        — its ``exposed_s`` where its ``clock()`` is given (telemetry on),
        else ``blocked_s``, the waits' whole time, which it equals where
        no blocked wait outlasted its transfer (both sides measure the same
        waits, so this is an instrumentation invariant, not a statistical
        one). Returns discrepancy messages (empty list = consistent).
        Skipped counts are tolerated only when the ring dropped events
        (``orphan_waits``)."""
        r = self.report()
        errors: List[str] = []
        seen_waits = r["waits_overlapped"] + r["waits_blocked"] \
            + self.orphan_waits
        stat_waits = (int(transfer_stats["waits_overlapped"])
                      + int(transfer_stats["waits_blocked"]))
        if self.orphan_waits == 0:
            for key in ("waits_overlapped", "waits_blocked"):
                if r[key] != int(transfer_stats[key]):
                    errors.append(f"{key}: trace={r[key]} "
                                  f"stats={int(transfer_stats[key])}")
        elif seen_waits != stat_waits:
            errors.append(f"total waits: trace={seen_waits} "
                          f"stats={stat_waits}")
        if self.orphan_waits == 0:
            name, stat = (("blocked_s", transfer_stats["blocked_s"])
                          if clock is None else
                          ("exposed_s", clock["exposed_s"]))
            diff = abs(r["exposed_s"] - float(stat))
            if diff > tol_s:
                errors.append(
                    f"exposed_s {r['exposed_s']:.6f} vs stats {name} "
                    f"{float(stat):.6f} "
                    f"(|diff| {diff:.6f} > tol {tol_s})")
        return errors
