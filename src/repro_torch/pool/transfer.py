"""Async transfer engine with explicit wait handles.

The counterpart of ``repro.pool.transfer``: transfers are issued on worker
threads ahead of use and the consumer waits on a ``TransferHandle``.
``depth`` bounds in-flight transfers; submitting past the bound first
retires the oldest outstanding transfer (backpressure).

A handle is one job on one worker: a thunk (``submit``), or the copies of
many pages (``submit_job``), grouped by the tier they read (``CopyGroup``).
A job of *n* pages counts as *n* transfers everywhere a transfer is
counted: ``issued``, ``completed``, the per tier-pair table, and the places
it holds against ``depth`` (a job larger than ``depth`` waits for an empty
pipeline).

On a CUDA device each job runs under the engine's copy stream for that
device, after the work the submitter's stream had enqueued when it
submitted (an event recorded there), and records an event after each of
its groups. The worker thread waits for those events, so a job counts as
complete only once its bytes have landed; ``wait()`` then makes the
consumer's stream wait on the last event and ``record_stream``s the
tensors the job returns, so the caching allocator never reuses their
memory early.

Stats distinguish waits that found the transfer already complete (hidden
under compute) from waits that blocked (exposed transfer time), and keep a
per tier-pair ``{transfers, bytes, busy_s}`` table: a group's ``busy_s`` is
the host time from the landing of the job's previous group (or the job's
start) to the landing of its own.

With telemetry on (an enabled tracer), the engine also times each copy
where it runs. A caller that wants its copies timed hands the backends a
list (``timings``); on a CUDA device they then queue their copies through
the engine's ``copy`` (a job's group, through ``copy_many``), which puts
them between two timing events on its stream (``CopyClock``: queued back
to back in one call, so neither the wait for the submitter's work nor a
stream left idle while a thread waited for the interpreter lock counts as
copy time) and appends their timing to the list: one bracket per job and
source tier. The engine maps the events onto the tracer's
``perf_counter`` clock. Where nothing was timed on the device (the CPU, a
copy in flight) a group's copy is its host interval (``busy_s``). Each
group's ``transfer`` span then covers its copies (a device-timed one on one
lane named for the copy stream), each pair row gains the copies'
``device_s``, and each job's first ``wait()`` splits its copies' time into
the part it found hidden and the part it was exposed to; ``clock()``
reports both. With telemetry off no list is handed over and no timing
event is recorded.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Deque, Dict, List, NamedTuple, Optional, Sequence, Tuple,
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
                    device_s: Optional[float] = None,
                    transfers: int = 1) -> None:
        b = self.pairs.setdefault(f"{src}->{dst}",
                                  {"transfers": 0, "bytes": 0, "busy_s": 0.0})
        b["transfers"] += int(transfers)
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


@dataclass
class CopyGroup:
    """The copies of one job that read one tier: ``queue(timings)`` queues
    them on the current stream (telemetry on: ``timings`` is a list their
    device timings go to, ``copy_many``), and ``pages`` transfers of
    ``nbytes`` in all are filed under ``src->dst`` (nothing is filed
    without ``src``, ``dst`` and ``nbytes``)."""

    queue: Callable[[Optional[List["CopyTiming"]]], None]
    pages: int = 1
    src: Optional[str] = None
    dst: Optional[str] = None
    nbytes: Optional[int] = None


def _tensors(value: Any) -> List[torch.Tensor]:
    """The tensors a job returned: the value itself, or those in a list."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [v for v in value if isinstance(v, torch.Tensor)]
    return []


class TransferHandle:
    """One in-flight job. ``wait()`` returns its value (idempotent)."""

    def __init__(self, key: Optional[str], seq: int, places: int,
                 device: Optional[torch.device],
                 engine: "TransferEngine") -> None:
        self.key = key
        self.seq = seq          # issue order
        self.places = places    # transfers it counts (its pages)
        self.device = device
        self._future: "Future" = None   # set once the job is queued
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
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in _tensors(value):
                t.record_stream(consumer)
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
    """Copies timed together on a CUDA device: the clock that timed them,
    its anchor when they were queued (host time, event), the timing events
    right before the first and after the last, and the copy engine's
    latency in the bracket (seconds)."""

    clock: "CopyClock"
    anchor: Tuple[float, _Event]
    events: Tuple[_Event, _Event]
    latency_s: float


#: a copy's direction by (source on the device, destination on the device)
_KINDS = {(False, True): "HtoD", (True, False): "DtoH", (True, True): "DtoD"}


def _copy_library() -> Tuple[Any, Any]:
    """The port's kernel library's timed copies (``csrc/timed_copy.cu``),
    which let go of the interpreter lock while they queue, and its read of
    a bracket's times, through ``ctypes.PyDLL``, which keeps the lock: a read
    of a microsecond is cheaper than handing the lock to another thread and
    waiting to get it back."""
    from repro_torch.kernels import build
    lib = build.load_library()
    times = ctypes.PyDLL(lib._name).hyperoffload_copy_times
    times.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_float)]
    times.restype = ctypes.c_int
    return lib.hyperoffload_timed_copies, times


def _check(err: int, what: str) -> None:
    if err != 0:
        from repro_torch.kernels import build
        build.check(err, what)


class CopyClock:
    """Times copies on one CUDA device, on the host's ``time.perf_counter``
    clock.

    Timed copies and the timing events before and after them are queued in
    one call into the port's kernel library (``csrc/timed_copy.cu``): no
    other thread can put anything between them on the stream, so the
    device meets the events right before the first copy and right after
    the last. Queued through torch, they are several calls, each letting go
    of the interpreter lock, and a thread that waits to get it back between
    them leaves the stream idle inside the bracket.

    Between the events the device also spends the copy engine's latency to
    start and finish a copy, some microseconds whatever its size, and a
    shorter one between copies queued back to back, which a profiler's
    record of the copies leaves out: the clock measures both in each
    direction on 4-byte copies when it is made (the median of five
    brackets of one copy, and of two, less that of one) and takes them off
    every bracket.

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
        #: by direction: (a bracket's first copy, each further copy)
        self.latency = {kind: (0.0, 0.0) for kind in _KINDS.values()}
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

    def _latencies(self) -> Dict[str, Tuple[float, float]]:
        host = torch.zeros(4, dtype=torch.uint8, pin_memory=True)
        dev = torch.zeros(4, dtype=torch.uint8, device=self.device)
        dev2 = torch.zeros_like(dev)
        out = {}
        stream = self._stream.cuda_stream

        def median(n: int) -> float:
            timings: List[CopyTiming] = []
            for _ in range(5):
                self.copies([(dst, src)] * n, stream, timings)
            self._stream.synchronize()
            return sorted(self.read([t])[1] for t in timings)[2]

        for dst, src in ((dev, host), (host, dev), (dev2, dev)):
            one = median(1)
            out[_KINDS[src.is_cuda, dst.is_cuda]] = \
                (one, max(median(2) - one, 0.0))
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

    def copies(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               stream: int, timings: List[CopyTiming]) -> None:
        """Queue each ``dst <- src`` of ``pairs`` (contiguous, of one size)
        on the raw CUDA ``stream``, back to back between one pair of timing
        events, and append their timing."""
        anchor = self.anchor
        if time.perf_counter() - anchor[0] > ANCHOR_RENEW_S:
            with self._renew:
                if time.perf_counter() - self.anchor[0] > ANCHOR_RENEW_S:
                    self.anchor = self._read()
                anchor = self.anchor
        events = self._events()
        n = len(pairs)
        _check(self._timed_copy(
            (ctypes.c_void_p * n)(*(d.data_ptr() for d, _ in pairs)),
            (ctypes.c_void_p * n)(*(s.data_ptr() for _, s in pairs)),
            (ctypes.c_size_t * n)(*(s.numel() * s.element_size()
                                    for _, s in pairs)),
            n, events[0][1], events[1][1], stream), "timed copy")
        kinds = [_KINDS[s.is_cuda, d.is_cuda] for d, s in pairs]
        timings.append(CopyTiming(
            self, anchor, events, self.latency[kinds[0]][0]
            + sum(self.latency[k][1] for k in kinds[1:])))

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
        self._held = 0      # places the in-flight handles hold
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
        """Queue ``dst <- src`` on the current stream (``copy_many``)."""
        self.copy_many([(dst, src)], timings)

    def copy_many(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  timings: Optional[List[CopyTiming]]) -> None:
        """Queue each ``dst <- src`` of ``pairs`` on the current stream, as
        ``dst.copy_(src, non_blocking=True)`` does. With a ``timings`` list,
        the copies between contiguous tensors of one type and shape with a
        side on a CUDA device are timed there, back to back between one
        pair of timing events (``CopyClock.copies``), and their timing
        appended to it; any other is queued untimed."""
        timed = []
        for dst, src in pairs:
            if (timings is not None and dst.dtype == src.dtype
                    and dst.shape == src.shape and dst.is_contiguous()
                    and src.is_contiguous() and (dst.is_cuda or src.is_cuda)):
                timed.append((dst, src))
            else:
                dst.copy_(src, non_blocking=True)
        if timed:
            dst, src = timed[0]
            device = dst.device if dst.is_cuda else src.device
            self._clock_for(device).copies(
                timed, torch._C._cuda_getCurrentRawStream(device.index),
                timings)

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
               device: Optional[torch.device] = None) -> TransferHandle:
        """Issue ``fn`` (a transfer thunk) asynchronously, as a job of one
        transfer whose copy is the thunk's host interval; its ``wait()``
        returns what ``fn`` returned."""
        out: List[Any] = []
        return self.submit_job(
            [CopyGroup(lambda timings: out.append(fn()), 1, src, dst,
                       nbytes)],
            lambda: out[0], key, device=device)

    def submit_job(self, groups: Sequence[CopyGroup],
                   result: Callable[[], Any], key: Optional[str] = None, *,
                   device: Optional[torch.device] = None) -> TransferHandle:
        """Issue a job: its groups queue their copies in order on one
        worker (on a CUDA ``device`` under the copy stream, after the
        submitter's work, in the submitter's inference mode), then
        ``result()`` gives what the handle's ``wait()`` returns. It holds
        one place against ``depth`` per page; a full pipeline first retires
        its oldest jobs."""
        cuda = device is not None and device.type == "cuda"
        stream = self.copy_stream(device) if cuda else None
        produced = None
        if cuda:
            # what the submitter enqueued so far, and nothing after it
            produced = torch.cuda.Event()
            produced.record(torch.cuda.current_stream(device))
        places = sum(g.pages for g in groups)
        job = (groups, result, stream, produced, self.tracer.enabled,
               torch.is_inference_mode_enabled(), device)
        while True:
            with self._lock:
                self._reap_locked()
                if not self._in_flight or self._held + places <= self.depth:
                    self._seq += 1
                    self.stats.issued += places
                    handle = TransferHandle(key, self._seq, places, device,
                                            self)
                    handle._future = self._pool.submit(self._run, handle,
                                                       *job)
                    self._in_flight.append(handle)
                    self._held += places
                    self.stats.max_in_flight = max(self.stats.max_in_flight,
                                                   self._held)
                    return handle
                oldest = self._pop_oldest_locked()
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

    def _run(self, handle: TransferHandle, groups: Sequence[CopyGroup],
             result: Callable[[], Any], stream, produced, timed: bool,
             inference: bool, device: Optional[torch.device]
             ) -> Tuple[Any, Optional["torch.cuda.Event"], Optional[float]]:
        """A job on its worker -> (value, the CUDA event of its last copy,
        with telemetry on the seconds of its copies)."""
        t_start = time.perf_counter()
        timings: List[Optional[List[CopyTiming]]] = []
        landed: List[float] = []    # host time each group was known landed
        events: List["torch.cuda.Event"] = []
        copies: List[Tuple[float, float]] = []   # telemetry on, per group
        try:
            with contextlib.ExitStack() as ctx:
                ctx.enter_context(torch.inference_mode(inference))
                if stream is not None:
                    stream.wait_event(produced)
                    ctx.enter_context(torch.cuda.stream(stream))
                for g in groups:
                    timings.append([] if timed else None)
                    g.queue(timings[-1])
                    if stream is None:
                        landed.append(time.perf_counter())
                    else:
                        events.append(torch.cuda.Event())
                        events[-1].record(stream)
                value = result()
            for event in events:
                event.synchronize()
                landed.append(time.perf_counter())
            if timed:
                for i, t in enumerate(timings):
                    begin = landed[i - 1] if i else t_start
                    copies.append(t[0].clock.read(t) if t else
                                  (begin, landed[i] - begin))
            return (value, events[-1] if events else None,
                    sum(c[1] for c in copies) if timed else None)
        finally:
            # a group's busy time runs from the landing of the one before
            # it (or the job's start) to its own; a failed job's, to now
            ends = landed + [time.perf_counter()] * (len(groups) - len(landed))
            with self._lock:
                self.stats.completed += handle.places
                for i, g in enumerate(groups):
                    if g.src and g.dst and g.nbytes is not None:
                        self.stats.record_pair(
                            g.src, g.dst, g.nbytes,
                            ends[i] - (ends[i - 1] if i else t_start),
                            copies[i][1] if i < len(copies) else None,
                            transfers=g.pages)
            for i, (t0, dur) in enumerate(copies):
                # copies timed on the device go on the copy stream's lane,
                # else the worker's
                self.tracer.complete(
                    "transfer", "transfer", t0, dur,
                    {"seq": handle.seq, "key": handle.key,
                     "src": groups[i].src, "dst": groups[i].dst,
                     "pages": groups[i].pages},
                    lane=copy_lane(device) if timings[i] else None)

    def drain(self) -> None:
        """Retire every outstanding transfer. Failed transfers don't stop
        the drain — their exceptions stay with their handles."""
        while True:
            with self._lock:
                if not self._in_flight:
                    return
                oldest = self._pop_oldest_locked()
            try:
                oldest.wait()
            except Exception:
                pass

    def close(self) -> None:
        self.drain()
        self._pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    def _pop_oldest_locked(self) -> TransferHandle:
        oldest = self._in_flight.popleft()
        self._held -= oldest.places
        return oldest

    def _reap_locked(self) -> None:
        while self._in_flight and self._in_flight[0]._future.done():
            self._pop_oldest_locked()

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

