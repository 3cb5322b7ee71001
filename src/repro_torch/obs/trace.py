"""Structured tracing: bounded in-memory ring + Chrome trace-event export.

(The PyTorch port's own copy of ``repro.obs.trace``, which it does not
import.)

The paper's latency-hiding claim is a statement about *when* things happen
— a transfer is hidden only if it runs under compute that was going to
happen anyway. Aggregate counters cannot show that; a trace can. `Tracer`
collects structured events (monotonic ``time.perf_counter`` timestamps,
category, name, args) into a bounded ring (oldest events drop first, so a
long-running server never grows without bound) and exports them as Chrome
trace-event JSON — loadable directly in Perfetto (https://ui.perfetto.dev)
or ``chrome://tracing``.

Event kinds mirror the trace-event format:

- **complete** (``ph="X"``) — a span with an explicit start + duration;
  the instrumented sites emit these at span *end*, so an event's presence
  implies the work finished;
- **instant** (``ph="i"``) — a point event (request state transitions,
  prefix lookups).

An event goes on the lane of the thread that emitted it, unless it names a
``lane`` of its own: the transfer engine puts the copies it timed on the
device on one lane named for the copy stream.

`NullTracer` is the disabled implementation: every method is a no-op and
``enabled`` is False so hot paths can skip building args dicts entirely —
telemetry off must cost nothing. Instrumented subsystems take a
``tracer=None`` kwarg and normalize it via ``or NULL_TRACER``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Union

__all__ = ["TraceEvent", "Tracer", "NullTracer", "NULL_TRACER"]


class TraceEvent:
    """One trace event. ``ts``/``dur`` are raw ``time.perf_counter``
    seconds; the exporter rebases them to microseconds. ``tid`` is the
    emitting thread's ident, or the name of the lane the event was put on."""

    __slots__ = ("cat", "name", "ph", "ts", "dur", "tid", "args")

    def __init__(self, cat: str, name: str, ph: str, ts: float,
                 dur: float = 0.0, tid: Union[int, str] = 0,
                 args: Optional[Dict[str, Any]] = None) -> None:
        self.cat = cat
        self.name = name
        self.ph = ph            # "X" complete span | "i" instant
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.args = args or {}

    @property
    def end(self) -> float:
        return self.ts + self.dur

    def __repr__(self) -> str:
        return (f"TraceEvent({self.cat}/{self.name} ph={self.ph} "
                f"ts={self.ts:.6f} dur={self.dur:.6f})")


class Tracer:
    """Bounded-ring structured tracer (see module doc). Thread-safe: the
    transfer engine's workers emit from their own threads."""

    enabled = True

    def __init__(self, capacity: int = 65536) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0
        self._t0 = time.perf_counter()   # export time base

    # -- emission ------------------------------------------------------
    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def complete(self, cat: str, name: str, ts: float, dur: float,
                 args: Optional[Dict[str, Any]] = None,
                 lane: Optional[str] = None) -> None:
        """A span that ran [ts, ts+dur] (emitted at span end), on the
        calling thread's lane or on the named ``lane``."""
        self._push(TraceEvent(cat, name, "X", ts, max(dur, 0.0),
                              threading.get_ident() if lane is None else lane,
                              args))

    def instant(self, cat: str, name: str,
                args: Optional[Dict[str, Any]] = None,
                ts: Optional[float] = None) -> None:
        self._push(TraceEvent(cat, name, "i",
                              self.now() if ts is None else ts,
                              0.0, threading.get_ident(), args))

    @contextmanager
    def span(self, cat: str, name: str, **args: Any) -> Iterator[None]:
        t0 = self.now()
        try:
            yield
        finally:
            self.complete(cat, name, t0, self.now() - t0, args or None)

    def _push(self, ev: TraceEvent) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1   # deque(maxlen) evicts the OLDEST
            self._ring.append(ev)

    # -- reading / export ----------------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    def events(self) -> List[TraceEvent]:
        """Snapshot of the ring, oldest first (newest always retained)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def snapshot(self) -> Dict[str, int]:
        return {"events": len(self._ring), "dropped": self.dropped,
                "capacity": self.capacity}

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (the ``traceEvents`` dict form).
        Timestamps are rebased to microseconds since the tracer's epoch;
        thread idents and lane names are remapped to small stable tids,
        named via ``M`` metadata events so Perfetto shows readable lanes (a
        named lane keeps its name, a thread is ``thread-<tid>``)."""
        events = self.events()
        tids: Dict[int, int] = {}
        out: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": "hyperoffload"},
        }]
        rows: List[Dict[str, Any]] = []
        for ev in events:
            tid = tids.setdefault(ev.tid, len(tids))
            row: Dict[str, Any] = {
                "name": ev.name, "cat": ev.cat, "ph": ev.ph,
                "ts": (ev.ts - self._t0) * 1e6, "pid": 1, "tid": tid,
            }
            if ev.ph == "X":
                row["dur"] = ev.dur * 1e6
            if ev.ph == "i":
                row["s"] = "t"   # thread-scoped instant
            if ev.args:
                row["args"] = ev.args
            rows.append(row)
        for ident, tid in tids.items():
            name = ident if isinstance(ident, str) else f"thread-{tid}"
            out.append({"name": "thread_name", "ph": "M", "pid": 1,
                        "tid": tid, "args": {"name": name}})
        out.extend(rows)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str) -> None:
        """Write the Chrome trace-event JSON file (open in Perfetto)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


class _NullSpan:
    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every method is a no-op. Hot paths gate arg
    construction on ``tracer.enabled`` so disabling telemetry costs one
    attribute read per site."""

    enabled = False
    dropped = 0
    capacity = 0

    now = staticmethod(time.perf_counter)

    def complete(self, cat: str, name: str, ts: float, dur: float,
                 args: Optional[Dict[str, Any]] = None,
                 lane: Optional[str] = None) -> None:
        pass

    def instant(self, cat: str, name: str,
                args: Optional[Dict[str, Any]] = None,
                ts: Optional[float] = None) -> None:
        pass

    def span(self, cat: str, name: str, **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def __len__(self) -> int:
        return 0

    def events(self) -> List[TraceEvent]:
        return []

    def clear(self) -> None:
        pass

    def snapshot(self) -> Dict[str, int]:
        return {"events": 0, "dropped": 0, "capacity": 0}


#: the shared no-op tracer — subsystems normalize ``tracer or NULL_TRACER``
NULL_TRACER = NullTracer()
