"""Async transfer engine with explicit wait handles.

The counterpart of ``repro.pool.transfer``: transfers are issued on worker
threads ahead of use and the consumer waits on a ``TransferHandle``.
``depth`` bounds in-flight transfers; submitting past the bound first
retires the oldest outstanding transfer (backpressure).

On a CUDA device each transfer runs under the engine's copy stream for that
device, after the work the submitter's stream had enqueued when it called
``submit`` (an event recorded there), and records an event of its own. The worker thread waits for that event, so
a transfer counts as complete only once its bytes have landed; ``wait()``
then makes the consumer's stream wait on the event and ``record_stream``s
the result, so the caching allocator never reuses its memory early.

Stats distinguish waits that found the transfer already complete (hidden
under compute) from waits that blocked (exposed transfer time), and keep a
per tier-pair ``{transfers, bytes, busy_s}`` table.

With telemetry on (an enabled tracer), the engine also times each copy
where it runs. A caller that wants its copies timed hands the backends a
list (``timings``); on a CUDA device they then queue their copies through
the engine's ``copy``, which puts each copy between two timing events on
its stream (``CopyClock``: queued back to back in one call, so neither the
wait for the submitter's work nor a stream left idle while a thread waited
for the interpreter lock counts as copy time) and appends its timing to
the list. The engine maps the events onto the tracer's ``perf_counter``
clock. Where nothing was timed on the device (the CPU, a copy in flight)
a transfer's copy is the host interval of its thunk. The ``transfer``
span then covers the copy (a device-timed one on one lane named for the
copy stream), each pair row gains the copies' ``device_s``, and each
transfer's first ``wait()`` splits the copy's time into the part it found
hidden and the part it was exposed to; ``clock()`` reports both. With
telemetry off no list is handed over and no timing event is recorded.
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Deque, Dict, List, NamedTuple, Optional, Tuple,
)

import torch

from repro_torch.obs.trace import NULL_TRACER

#: how often ``CopyClock`` renews its anchor: the device's timer and the
#: host's clock drift apart by some parts in a million, so a fresh anchor
#: every quarter second keeps the drift within microseconds
ANCHOR_RENEW_S = 0.25

#: floor for the auto depth policy — always enough for classic double
#: buffering plus a few leaves of headroom
MIN_AUTO_DEPTH = 8


def auto_depth(*, layers: Optional[int] = None, pages: Optional[int] = None,
               minimum: int = MIN_AUTO_DEPTH) -> int:
    """The transfer-depth policy: one step's worth of fetches issues
    completely before anything waits, while staging memory stays bounded.

    - whole-cache round trips (``ServeEngine``): 2 K/V leaves per layer plus
      2× headroom → ``4 * layers``;
    - page-granular prefetch (``PagedKVCache``): every page's K and V fetch
      in flight at once → ``2 * pages``.
    """
    depth = int(minimum)
    if layers:
        depth = max(depth, 4 * int(layers))
    if pages:
        depth = max(depth, 2 * int(pages))
    return depth


@dataclass
class TransferStats:
    issued: int = 0
    completed: int = 0
    waits_overlapped: int = 0   # consumer wait() found the transfer done
    waits_blocked: int = 0      # consumer wait() had to block (exposed time)
    blocked_s: float = 0.0      # total consumer-exposed transfer time
    backpressure_waits: int = 0  # submits stalled by a full pipeline
    backpressure_s: float = 0.0  # time submit() spent retiring transfers
    max_in_flight: int = 0
    #: measured per tier-pair movement, keyed "src->dst": {transfers, bytes,
    #: busy_s}, busy_s summed per-transfer execution time (not wall time);
    #: with telemetry on also ``device_s``, the copies' own time (on the
    #: card between timing events on the copy stream), read by ``clock()``
    pairs: Dict[str, Dict[str, float]] = field(default_factory=dict)
    #: telemetry on: of each waited transfer's copy time, the part its
    #: first wait found already done, and the part the wait blocked on
    hidden_s: float = 0.0
    exposed_s: float = 0.0

    def record_pair(self, src: str, dst: str, nbytes: int, seconds: float,
                    device_s: Optional[float] = None) -> None:
        b = self.pairs.setdefault(f"{src}->{dst}",
                                  {"transfers": 0, "bytes": 0, "busy_s": 0.0})
        b["transfers"] += 1
        b["bytes"] += int(nbytes)
        b["busy_s"] += float(seconds)
        if device_s is not None:
            b["device_s"] = b.get("device_s", 0.0) + float(device_s)

    def clock_snapshot(self) -> Dict[str, Any]:
        return {"hidden_s": self.hidden_s, "exposed_s": self.exposed_s,
                "pairs": {k: {"transfers": v["transfers"],
                              "bytes": v["bytes"], "device_s": v["device_s"]}
                          for k, v in self.pairs.items() if "device_s" in v}}

    def snapshot(self) -> Dict[str, Any]:
        return {
            "issued": self.issued, "completed": self.completed,
            "waits_overlapped": self.waits_overlapped,
            "waits_blocked": self.waits_blocked,
            "blocked_s": self.blocked_s,
            "backpressure_waits": self.backpressure_waits,
            "backpressure_s": self.backpressure_s,
            "max_in_flight": self.max_in_flight,
            "pairs": {k: {"transfers": v["transfers"], "bytes": v["bytes"],
                          "busy_s": v["busy_s"]}
                      for k, v in self.pairs.items()},
        }


class TransferHandle:
    """One in-flight transfer. ``wait()`` returns its value (idempotent)."""

    def __init__(self, key: Optional[str], seq: int, future: "Future",
                 engine: "TransferEngine") -> None:
        self.key = key
        self.seq = seq          # issue order
        self._future = future
        self._engine = engine
        self._waited = False

    @property
    def done(self) -> bool:
        """The transfer's bytes have landed (queried on its CUDA event)."""
        if not self._future.done():
            return False
        if self._future.exception() is not None:
            return True
        event = self._future.result()[1]
        return event is None or event.query()

    def wait(self) -> Any:
        """Idempotent; only the first wait is charged to the stats (and
        traced)."""
        was_done = self.done
        t0 = time.perf_counter()
        value, event, copy_s = self._future.result()
        if event is not None:
            consumer = torch.cuda.current_stream(value.device)
            consumer.wait_event(event)
            value.record_stream(consumer)
        if not self._waited:
            self._waited = True
            dur = time.perf_counter() - t0
            self._engine._record_wait(was_done, dur, copy_s)
            tracer = self._engine.tracer
            if tracer.enabled:
                tracer.complete("transfer", "transfer.wait", t0, dur,
                                {"seq": self.seq, "hit": was_done})
        return value

    def __repr__(self) -> str:
        state = "done" if self.done else "in-flight"
        return f"TransferHandle({self.key!r}, seq={self.seq}, {state})"


#: a timing event and its raw handle (read once: the property costs a call)
_Event = Tuple["torch.cuda.Event", int]


class CopyTiming(NamedTuple):
    """One copy timed on a CUDA device: the clock that timed it, its anchor
    when the copy was queued (host time, event), the timing events right
    before and after the copy, and the copy engine's latency in its
    direction (seconds)."""

    clock: "CopyClock"
    anchor: Tuple[float, _Event]
    events: Tuple[_Event, _Event]
    latency_s: float


#: a copy's direction by (source on the device, destination on the device)
_KINDS = {(False, True): "HtoD", (True, False): "DtoH", (True, True): "DtoD"}


def _copy_library() -> Tuple[Any, Any]:
    """The port's kernel library's timed copy (``csrc/timed_copy.cu``),
    which lets go of the interpreter lock while it queues, and its read of
    a copy's times, through ``ctypes.PyDLL``, which keeps the lock: a read
    of a microsecond is cheaper than handing the lock to another thread and
    waiting to get it back."""
    from repro_torch.kernels import build
    lib = build.load_library()
    times = ctypes.PyDLL(lib._name).hyperoffload_copy_times
    times.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_float)]
    times.restype = ctypes.c_int
    return lib.hyperoffload_timed_copy, times


def _check(err: int, what: str) -> None:
    if err != 0:
        from repro_torch.kernels import build
        build.check(err, what)


class CopyClock:
    """Times copies on one CUDA device, on the host's ``time.perf_counter``
    clock.

    A timed copy and the timing events before and after it are queued in
    one call into the port's kernel library (``csrc/timed_copy.cu``): no
    other thread can put anything between them on the stream, so the
    device meets the events right before and right after the copy. Queued
    through torch, they are three calls, each letting go of the interpreter
    lock, and a thread that waits to get it back between them leaves the
    stream idle inside the bracket.

    Between the events the device also spends the copy engine's latency to
    start and finish a copy, some microseconds whatever its size, which a
    profiler's record of the copy leaves out: the clock measures it in each
    direction on 4-byte copies when it is made (the median of five) and
    takes it off every copy.

    The anchor is a host reading and a timing event recorded on a stream of
    the clock's own, which carries nothing else, so the event runs as soon
    as the device takes it: the best of three readings bracketed by the
    host clock, taken when the clock is made and renewed every
    ``ANCHOR_RENEW_S``. An event's host time is the anchor's plus the
    device time elapsed between them. Timing events go back to a pool once
    read (a deque: its ``append`` and ``pop`` need no lock)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._stream = torch.cuda.Stream(device=device)
        self._renew = threading.Lock()
        self._free: Deque[Tuple[_Event, _Event]] = deque()
        self._timed_copy, self._copy_times = _copy_library()
        self.anchor = self._read()
        self.latency = {kind: 0.0 for kind in _KINDS.values()}
        self.latency = self._latencies()

    def _read(self) -> Tuple[float, _Event]:
        best = None
        for _ in range(3):
            event = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            event.record(self._stream)
            t1 = time.perf_counter()
            if best is None or t1 - t0 < best[0]:
                best = (t1 - t0, 0.5 * (t0 + t1), event)
        best[2].synchronize()
        return best[1], (best[2], best[2].cuda_event)

    def _latencies(self) -> Dict[str, float]:
        host = torch.zeros(4, dtype=torch.uint8, pin_memory=True)
        dev = torch.zeros(4, dtype=torch.uint8, device=self.device)
        dev2 = torch.zeros_like(dev)
        out = {}
        stream = self._stream.cuda_stream
        for dst, src in ((dev, host), (host, dev), (dev2, dev)):
            timings: List[CopyTiming] = []
            for _ in range(5):
                self.copy(dst, src, stream, timings)
            self._stream.synchronize()
            seconds = sorted(self.read([t])[1] for t in timings)
            out[_KINDS[src.is_cuda, dst.is_cuda]] = seconds[2]
        return out

    def _events(self) -> Tuple[_Event, _Event]:
        try:
            return self._free.pop()
        except IndexError:
            pass
        made = []
        for _ in range(2):
            event = torch.cuda.Event(enable_timing=True)
            event.record(self._stream)   # made now: the library takes its
            made.append((event, event.cuda_event))   # handle
        return made[0], made[1]

    def copy(self, dst: torch.Tensor, src: torch.Tensor, stream: int,
             timings: List[CopyTiming]) -> None:
        """Queue ``dst <- src`` (contiguous, of one size) on the raw CUDA
        ``stream`` between two timing events, and append its timing."""
        anchor = self.anchor
        if time.perf_counter() - anchor[0] > ANCHOR_RENEW_S:
            with self._renew:
                if time.perf_counter() - self.anchor[0] > ANCHOR_RENEW_S:
                    self.anchor = self._read()
                anchor = self.anchor
        events = self._events()
        _check(self._timed_copy(dst.data_ptr(), src.data_ptr(),
                                src.numel() * src.element_size(),
                                events[0][1], events[1][1], stream),
               "timed copy")
        timings.append(CopyTiming(self, anchor, events,
                                  self.latency[_KINDS[src.is_cuda,
                                                      dst.is_cuda]]))

    def read(self, timings: List[CopyTiming]) -> Tuple[float, float]:
        """(start of the first on the host clock, seconds summed, each
        direction's latency taken off) of timed copies whose end events
        have run; their events go back to the pool."""
        start, seconds = None, 0.0
        ms = (ctypes.c_float * 2)()
        for _, (t0, anchor), events, latency_s in timings:
            _check(self._copy_times(anchor[1], events[0][1], events[1][1],
                                    ms), "copy times")
            self._free.append(events)
            if start is None:
                start = t0 + ms[0] * 1e-3
            seconds += max(ms[1] * 1e-3 - latency_s, 0.0)
        return start, seconds


def copy_lane(device: torch.device) -> str:
    """The trace lane of a device's copy stream."""
    return f"copy stream {device}"


class TransferEngine:
    def __init__(self, depth: int = 2, workers: int = 2,
                 tracer=None) -> None:
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.depth = depth
        self.depth_pinned = False   # True: ensure_depth never raises depth
        self.workers = workers
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="pool-xfer")
        self._in_flight: Deque[TransferHandle] = deque()
        self._lock = threading.Lock()
        self._seq = 0
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self._clocks: Dict[int, CopyClock] = {}   # by device index
        self.stats = TransferStats()
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def set_tracer(self, tracer) -> None:
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def copy_stream(self, device: torch.device) -> "torch.cuda.Stream":
        """The engine's copy stream on a CUDA device (made on first use)."""
        with self._lock:
            stream = self._streams.get(device)
            if stream is None:
                stream = torch.cuda.Stream(device=device)
                self._streams[device] = stream
            return stream

    def _clock_for(self, device: torch.device) -> CopyClock:
        """The device's ``CopyClock`` (made at its first timed copy)."""
        clock = self._clocks.get(device.index)
        if clock is None:
            with self._lock:
                clock = self._clocks.get(device.index)
                if clock is None:
                    clock = self._clocks[device.index] = CopyClock(device)
        return clock

    def copy(self, dst: torch.Tensor, src: torch.Tensor,
             timings: List[CopyTiming]) -> None:
        """Queue ``dst <- src`` on the current stream, as
        ``dst.copy_(src, non_blocking=True)`` does. A copy between
        contiguous tensors of one type and shape with a side on a CUDA
        device is timed there (``CopyClock.copy``) and its timing appended
        to ``timings``; any other is queued untimed."""
        if (dst.dtype == src.dtype and dst.shape == src.shape
                and dst.is_contiguous() and src.is_contiguous()):
            device = dst.device if dst.is_cuda else src.device
            if device.type == "cuda":
                self._clock_for(device).copy(
                    dst, src, torch._C._cuda_getCurrentRawStream(device.index),
                    timings)
                return
        dst.copy_(src, non_blocking=True)

    @staticmethod
    def copy_seconds(timings: Optional[List[CopyTiming]],
                     host_s: float) -> Optional[float]:
        """The device seconds of the copies a synchronous transfer timed
        into ``timings`` (their end events have run), or ``host_s`` where
        it timed none; None where it was handed no list (telemetry off)."""
        if timings is None:
            return None
        return timings[0].clock.read(timings)[1] if timings else host_s

    def record_pair(self, src: str, dst: str, nbytes: int, seconds: float,
                    device_s: Optional[float] = None) -> None:
        """Record one synchronous transfer into the per-pair table: its
        host seconds, and with telemetry on its copy's (``copy_seconds``)."""
        with self._lock:
            self.stats.record_pair(src, dst, nbytes, seconds, device_s)

    def clock(self) -> Dict[str, Any]:
        """The copies' own time (telemetry on): ``hidden_s``, ``exposed_s``
        and per tier pair ``{transfers, bytes, device_s}``."""
        with self._lock:
            return self.stats.clock_snapshot()

    def ensure_depth(self, depth: int) -> None:
        """Raise the in-flight bound to at least ``depth`` (never lowers):
        each consumer of a shared engine declares the depth its issue
        pattern needs. A pinned depth (``depth_pinned``) is never raised."""
        with self._lock:
            if not self.depth_pinned:
                self.depth = max(self.depth, int(depth))

    def ensure_workers(self, workers: int) -> None:
        """Raise the worker-thread count to at least ``workers`` (never
        lowers): the knob the calibration loop turns when a step's fetches
        need more transfers in flight than the workers allow. Drains the
        outstanding transfers, then swaps the thread pool — call it at a
        step boundary, where every consumer has already waited."""
        workers = int(workers)
        if workers <= self.workers:
            return
        self.drain()
        old = self._pool
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="pool-xfer")
        self.workers = workers
        old.shutdown(wait=True)

    # ------------------------------------------------------------------
    def submit(self, fn: Callable[[], Any], key: Optional[str] = None, *,
               src: Optional[str] = None, dst: Optional[str] = None,
               nbytes: Optional[int] = None,
               device: Optional[torch.device] = None,
               timings: Optional[List[CopyTiming]] = None
               ) -> TransferHandle:
        """Issue ``fn`` (a transfer thunk) asynchronously; on a CUDA
        ``device`` it runs under the copy stream. Blocks on the oldest
        outstanding transfer first when the pipeline is full. With
        telemetry on, ``timings`` is the list ``fn``'s copies append their
        device timings to (``copy``): the transfer's copy is theirs, or the
        host interval of ``fn`` where it timed none."""
        cuda = device is not None and device.type == "cuda"
        stream = self.copy_stream(device) if cuda else None
        produced = None
        if cuda:
            # what the submitter enqueued so far, and nothing after it
            produced = torch.cuda.Event()
            produced.record(torch.cuda.current_stream(device))
        if self.tracer.enabled and timings is None:
            timings = []
        elif not self.tracer.enabled:
            timings = None
        while True:
            with self._lock:
                self._reap_locked()
                if len(self._in_flight) < self.depth:
                    self._seq += 1
                    seq = self._seq
                    self.stats.issued += 1

                    def run() -> Tuple[Any, Optional["torch.cuda.Event"],
                                       Optional[float]]:
                        # -> (value, its CUDA event, with telemetry on the
                        # seconds of its copy)
                        copy = None   # telemetry on: (start, seconds)
                        t_start = time.perf_counter()
                        try:
                            if stream is None:
                                value, event = fn(), None
                            else:
                                stream.wait_event(produced)
                                with torch.cuda.stream(stream):
                                    value = fn()
                                    event = torch.cuda.Event()
                                    event.record(stream)
                                event.synchronize()
                            if timings is not None:
                                copy = (timings[0].clock.read(timings)
                                        if timings else
                                        (t_start,
                                         time.perf_counter() - t_start))
                            return value, event, copy and copy[1]
                        finally:
                            t_done = time.perf_counter()
                            with self._lock:
                                self.stats.completed += 1
                                if src and dst and nbytes is not None:
                                    self.stats.record_pair(
                                        src, dst, nbytes, t_done - t_start,
                                        copy and copy[1])
                            if timings is not None:
                                # a copy timed on the device goes on the
                                # copy stream's lane, else the worker's
                                t0, dur = copy or (t_start,
                                                   t_done - t_start)
                                self.tracer.complete(
                                    "transfer", "transfer", t0, dur,
                                    {"seq": seq, "key": key,
                                     "src": src, "dst": dst},
                                    lane=copy_lane(device) if timings
                                    else None)

                    handle = TransferHandle(key, seq,
                                            self._pool.submit(run), self)
                    self._in_flight.append(handle)
                    self.stats.max_in_flight = max(self.stats.max_in_flight,
                                                   len(self._in_flight))
                    return handle
                oldest = self._in_flight.popleft()
            # never block on a future while holding the lock — the worker's
            # completion accounting needs it. A failed transfer's exception
            # belongs to its own handle's wait(), not to this submitter.
            t0 = time.perf_counter()
            try:
                oldest._future.result()
            except Exception:
                pass
            dur = time.perf_counter() - t0
            with self._lock:
                self.stats.backpressure_waits += 1
                self.stats.backpressure_s += dur
            if self.tracer.enabled:
                self.tracer.complete("transfer", "transfer.backpressure",
                                     t0, dur, {"stalled_on": oldest.seq})

    def drain(self) -> None:
        """Retire every outstanding transfer. Failed transfers don't stop
        the drain — their exceptions stay with their handles."""
        while True:
            with self._lock:
                if not self._in_flight:
                    return
                oldest = self._in_flight.popleft()
            try:
                oldest.wait()
            except Exception:
                pass

    def close(self) -> None:
        self.drain()
        self._pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    def _reap_locked(self) -> None:
        while self._in_flight and self._in_flight[0]._future.done():
            self._in_flight.popleft()

    def _record_wait(self, was_done: bool, blocked_s: float,
                     copy_s: Optional[float]) -> None:
        with self._lock:
            # a waited transfer leaves the queue now, not at the next submit:
            # its handle holds the fetched tensor
            self._reap_locked()
            if was_done:
                self.stats.waits_overlapped += 1
            else:
                self.stats.waits_blocked += 1
                self.stats.blocked_s += blocked_s
            if copy_s is not None:
                # a blocked wait also covers what the copy waited for (the
                # submitter's work, a worker): only copy time is exposed
                exposed = 0.0 if was_done else min(blocked_s, copy_s)
                self.stats.exposed_s += exposed
                self.stats.hidden_s += copy_s - exposed

