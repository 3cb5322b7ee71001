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
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Optional, Tuple

import torch

from repro_torch.obs.trace import NULL_TRACER

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
    #: busy_s}, busy_s summed per-transfer execution time (not wall time)
    pairs: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def record_pair(self, src: str, dst: str, nbytes: int,
                    seconds: float) -> None:
        b = self.pairs.setdefault(f"{src}->{dst}",
                                  {"transfers": 0, "bytes": 0, "busy_s": 0.0})
        b["transfers"] += 1
        b["bytes"] += int(nbytes)
        b["busy_s"] += float(seconds)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "issued": self.issued, "completed": self.completed,
            "waits_overlapped": self.waits_overlapped,
            "waits_blocked": self.waits_blocked,
            "blocked_s": self.blocked_s,
            "backpressure_waits": self.backpressure_waits,
            "backpressure_s": self.backpressure_s,
            "max_in_flight": self.max_in_flight,
            "pairs": {k: dict(v) for k, v in self.pairs.items()},
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
        value, event = self._future.result()
        if event is not None:
            consumer = torch.cuda.current_stream(value.device)
            consumer.wait_event(event)
            value.record_stream(consumer)
        if not self._waited:
            self._waited = True
            dur = time.perf_counter() - t0
            self._engine._record_wait(was_done, dur)
            tracer = self._engine.tracer
            if tracer.enabled:
                tracer.complete("transfer", "transfer.wait", t0, dur,
                                {"seq": self.seq, "key": self.key,
                                 "hit": was_done})
        return value

    def __repr__(self) -> str:
        state = "done" if self.done else "in-flight"
        return f"TransferHandle({self.key!r}, seq={self.seq}, {state})"


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

    def record_pair(self, src: str, dst: str, nbytes: int,
                    seconds: float) -> None:
        """Record one synchronous transfer into the per-pair table."""
        with self._lock:
            self.stats.record_pair(src, dst, nbytes, seconds)

    # ------------------------------------------------------------------
    def submit(self, fn: Callable[[], Any], key: Optional[str] = None, *,
               src: Optional[str] = None, dst: Optional[str] = None,
               nbytes: Optional[int] = None,
               device: Optional[torch.device] = None) -> TransferHandle:
        """Issue ``fn`` (a transfer thunk) asynchronously; on a CUDA
        ``device`` it runs under the copy stream. Blocks on the oldest
        outstanding transfer first when the pipeline is full."""
        cuda = device is not None and device.type == "cuda"
        stream = self.copy_stream(device) if cuda else None
        produced = None
        if cuda:
            # what the submitter enqueued so far, and nothing after it
            produced = torch.cuda.Event()
            produced.record(torch.cuda.current_stream(device))
        while True:
            with self._lock:
                self._reap_locked()
                if len(self._in_flight) < self.depth:
                    self._seq += 1
                    seq = self._seq
                    self.stats.issued += 1

                    def run() -> Tuple[Any, Optional["torch.cuda.Event"]]:
                        t_start = time.perf_counter()
                        try:
                            if stream is None:
                                return fn(), None
                            stream.wait_event(produced)
                            with torch.cuda.stream(stream):
                                value = fn()
                                event = torch.cuda.Event()
                                event.record(stream)
                            event.synchronize()
                            return value, event
                        finally:
                            t_done = time.perf_counter()
                            with self._lock:
                                self.stats.completed += 1
                                if src and dst and nbytes is not None:
                                    self.stats.record_pair(
                                        src, dst, nbytes, t_done - t_start)
                            if self.tracer.enabled:
                                self.tracer.complete(
                                    "transfer", "transfer", t_start,
                                    t_done - t_start,
                                    {"seq": seq, "key": key,
                                     "src": src, "dst": dst})

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

    def _record_wait(self, was_done: bool, blocked_s: float) -> None:
        with self._lock:
            # a waited transfer leaves the queue now, not at the next submit:
            # its handle holds the fetched tensor
            self._reap_locked()
            if was_done:
                self.stats.waits_overlapped += 1
            else:
                self.stats.waits_blocked += 1
                self.stats.blocked_s += blocked_s
