"""The device's side of a traced run, from ``torch.profiler`` (CUPTI).

The profiler records the card's activity only (kernels, copies, sets), so
the host pays little for it. Its timestamps are put on the host's
``perf_counter`` clock by two anchors: at the start and at the stop the
device is drained, the host clock read, and a short spin kernel launched;
the kernel's recorded start, less that host time, is the offset.

From the events it gives the busy seconds (the union of every device
interval in the traced slice), the idle gaps between them, each kernel's
interval on the host clock, and the device time by operation name.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

ANCHOR_NAME = "spin_kernel"
ANCHOR_CYCLES = 1000


class DeviceTrace:
    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.running = False
        self._prof = None
        self._anchors: List[float] = []
        self._epoch: List[float] = []     # time.time() - perf_counter()
        self.t_start = self.t_stop = 0.0
        #: (name, start, end) on the host clock, by start
        self.events: List[Tuple[str, float, float]] = []
        self.offset_drift_s: Optional[float] = None
        self.anchors_seen = 0

    def _anchor(self) -> float:
        torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self._epoch.append(time.time() - t)
        torch.cuda._sleep(ANCHOR_CYCLES)
        self._anchors.append(t)
        return t

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self.t_start = self._anchor()
        self.running = True

    def stop(self) -> None:
        self.t_stop = self._anchor()
        torch.cuda.synchronize(self.device)
        self._prof.stop()
        self.running = False
        self._read()
        self._prof = None

    def _read(self) -> None:
        from torch.autograd import DeviceType
        raw = [(e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        anchors = sorted(s for n, s, _ in raw if ANCHOR_NAME in n)
        self.anchors_seen = len(anchors)
        if len(anchors) >= 2:
            off0 = anchors[0] - self._anchors[0]
            off1 = anchors[-1] - self._anchors[-1]
        else:
            # no anchor kernel recorded: the profiler's clock is the wall
            # clock, so map through it (good to about a millisecond)
            off0, off1 = self._epoch[0], self._epoch[-1]
        self.offset_drift_s = off1 - off0
        off = 0.5 * (off0 + off1)
        self.events = sorted(((n, s - off, e - off) for n, s, e in raw
                              if ANCHOR_NAME not in n), key=lambda x: x[1])

    # -- readings -------------------------------------------------------
    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of every device interval, clipped to the slice."""
        out: List[Tuple[float, float]] = []
        for _, s, e in self.events:
            s, e = max(s, self.t_start), min(e, self.t_stop)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.t_start
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t_stop > t:
            gaps.append((t, self.t_stop))
        return gaps

    def kernels(self, fragment: str) -> List[Tuple[float, float]]:
        """(start, end) of every event whose name holds ``fragment``."""
        return [(s, e) for n, s, e in self.events if fragment in n]

    def time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.events:
            key = short_name(n)
            out[key] = out.get(key, 0.0) + (e - s)
        return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    base = name.replace("(anonymous namespace)::", "").strip()
    if base.startswith("void "):
        base = base[5:]
    base = base.split("(")[0].split("<")[0].strip()
    return base[:80] or name[:80]


def label_gaps(gaps: Sequence[Tuple[float, float]],
               spans: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Idle seconds by the innermost host span open at each gap's middle
    (``host/none`` where no span was open). Spans of one name do not nest,
    so each name's latest span to start before the middle is the only one
    of that name that can hold it."""
    by_name: Dict[str, List[Tuple[float, float]]] = {}
    for name, s, e in spans:
        by_name.setdefault(name, []).append((s, e))
    index = {n: (sorted(v), [s for s, _ in sorted(v)])
             for n, v in by_name.items()}
    out: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        best, best_len = "host/none", float("inf")
        for name, (ivs, starts) in index.items():
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and ivs[i][1] >= mid and ivs[i][1] - ivs[i][0] < best_len:
                best, best_len = name, ivs[i][1] - ivs[i][0]
        out[best] = out.get(best, 0.0) + (b - a)
    return out
