"""One run of a serving cell: the port's front door under open-loop load.

Set-up builds the weights (``weights``), the port's ``HyperOffloadSession``
and its scheduler with the cell's layout, and serves one warm-up request.
Then the lead-in's arrivals start on the host clock, and the window opens
``lead_in_s`` later. The loop:

- submits every request whose due time has passed, with ``arrival =
  sched.now``, so the scheduler's virtual clock never holds it back;
- calls ``step()`` while anything is queued or running, and stamps each
  token the step emitted with the host time at which it returned;
- otherwise sleeps until the next due time.

It stops at the first pass after the window closes. With ``trace`` the
session's telemetry is on, the loop records its own spans (``bench/submit``,
``bench/step``, ``bench/idle``), and ``devtrace`` profiles the device over
the first ``PROFILE_S`` seconds of the window.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench.harness import traffic, weights
from perfbench.harness.devtrace import DeviceTrace
from perfbench.harness.spec import Cell, port_config
from perfbench.harness.stats import Served

#: the traced slice of the window (device profiler), seconds
PROFILE_S = 10.0
#: the session tracer's ring in traced runs: every page's put and fetch of
#: a whole window fits
TRACE_RING = 1 << 21


@dataclasses.dataclass
class Step:
    """One scheduler step as the loop saw it: host start and return, the
    prompt lengths it prefilled (in order) and the positions of the rows its
    decode wrote (live rows only)."""

    t0: float
    t1: float
    prefills: List[int]
    decode_pos: List[int]


@dataclasses.dataclass
class Window:
    cell: Cell
    params: Dict                      # the benchmark's weights
    served: List[Served]
    t_open: float
    t_close: float
    steps: List[Step]
    setup_s: float
    memory_peak_bytes: Optional[int]
    stats_open: Dict[str, Any]        # session.stats() at the window's open
    stats_close: Dict[str, Any]
    spans: List[Tuple[str, float, float]]
    device_trace: Optional[DeviceTrace]


def build(cell: Cell, seed: int, device: torch.device, trace: bool,
          session_options: Optional[Dict[str, Any]] = None):
    """(params, session, scheduler) for the cell;
    ``session_options`` are further ``OffloadConfig`` fields (the
    tests' and the calibration tool's way to switch on the program's own
    lower-precision path)."""
    from repro_torch.api import HyperOffloadSession, OffloadConfig
    from repro_torch.api.config import CACHE_DTYPES, TelemetryConfig
    from repro_torch.models.model import build_model
    from repro_torch.offload.kvcache import worst_case_page_bytes

    cfg = port_config(cell.config)
    dtype = CACHE_DTYPES[cell.config["torch_dtype"]]
    model = build_model(cfg)
    params = weights.make_params(model, seed, dtype, device)
    lay = cell.layout
    kw: Dict[str, Any] = dict(
        mode=cell.mode, max_batch=lay["max_batch"], max_seq=lay["max_seq"],
        prefill_budget=lay["prefill_budget"],
        cache_dtype=cell.config["cache_dtype"])
    if cell.offload:
        row = worst_case_page_bytes(model.cache_specs(
            1, lay["max_seq"], CACHE_DTYPES[cell.config["cache_dtype"]]))
        kw.update(device_capacity=lay["device_tier_rows"] * row,
                  host_capacity=lay["host_tier_rows"] * row)
    if trace:
        kw["telemetry"] = TelemetryConfig(enable=True, ring_capacity=TRACE_RING)
    kw.update(session_options or {})
    session = HyperOffloadSession(OffloadConfig(**kw), device=device)
    sched = session.scheduler(model, params)
    return params, session, sched


def _warm_up(sched, cell: Cell) -> None:
    """One request of the mix's shortest prompt through prefill and two
    decode steps: loads the kernel library and touches every code path a
    step takes before the lead-in's clock starts."""
    import numpy as np
    from repro_torch.sched import Request
    n = cell.mix["prompt_tokens"]["min"]
    sched.submit(Request(np.zeros(n, np.int32), 3, arrival=sched.now))
    while len(sched.queue) or sched.active:
        sched.step()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, *,
        lead_in_s: Optional[float] = None,
        session_options: Optional[Dict[str, Any]] = None
        ) -> Tuple[Window, Any]:
    """Serve one run; returns the window and the session (still open: the
    caller reads what it needs and closes it)."""
    params, session, sched = build(cell, seed, device, trace,
                                   session_options)
    _warm_up(sched, cell)
    lead = cell.mix["lead_in_s"] if lead_in_s is None else lead_in_s
    arrivals = traffic.schedule(dict(cell.mix, lead_in_s=lead), cell.rate,
                                seconds, seed, cell.config["vocab_size"])
    from repro_torch.sched import Request

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    t_open, t_close = t0 + lead, t0 + lead + seconds
    served = [Served(due=t0 + a.due_s, submitted=None,
                     prompt_len=int(a.prompt.shape[0]),
                     max_new_tokens=a.max_new_tokens, prompt=a.prompt)
              for a in arrivals]
    by_req: Dict[int, int] = {}
    steps: List[Step] = []
    spans: List[Tuple[str, float, float]] = []
    dtrace = DeviceTrace(device) if (trace and cuda) else None
    opened = False
    stats_open: Dict[str, Any] = {}
    nxt = 0
    while True:
        now = time.perf_counter()
        if now >= t_close:
            break
        if not opened and now >= t_open:
            opened = True
            stats_open = session.stats()
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            if dtrace is not None:
                dtrace.start()
        if dtrace is not None and dtrace.running \
                and now >= t_open + PROFILE_S:
            dtrace.stop()
        if nxt < len(arrivals) and served[nxt].due <= now:
            while nxt < len(arrivals) and served[nxt].due <= now:
                a = arrivals[nxt]
                req = Request(a.prompt, a.max_new_tokens, arrival=sched.now)
                try:
                    sched.submit(req)
                except ValueError:
                    served[nxt].failed = True
                by_req[req.req_id] = nxt
                served[nxt].submitted = time.perf_counter()
                nxt += 1
            if trace:
                spans.append(("bench/submit", now, time.perf_counter()))
        if len(sched.queue) or sched.active:
            s0 = time.perf_counter()
            emitted = sched.step()
            s1 = time.perf_counter()
            step = Step(s0, s1, [], [])
            for rid, tok in emitted:
                r = served[by_req[rid]]
                i = len(r.tokens)
                if i == 0:
                    step.prefills.append(r.prompt_len)
                else:
                    step.decode_pos.append(r.prompt_len + i - 1)
                r.tokens.append(int(tok))
                r.stamps.append(s1)
            steps.append(step)
            if trace:
                spans.append(("bench/step", s0, s1))
        else:
            wake = min(served[nxt].due if nxt < len(arrivals) else t_close,
                       t_close if opened else t_open)
            if dtrace is not None and dtrace.running:
                wake = min(wake, t_open + PROFILE_S)
            s0 = time.perf_counter()
            time.sleep(max(0.0, wake - s0))
            if trace:
                spans.append(("bench/idle", s0, time.perf_counter()))
    if cuda:
        torch.cuda.synchronize(device)
    if dtrace is not None and dtrace.running:
        dtrace.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    win = Window(cell=cell, params=params, served=served,
                 t_open=t_open, t_close=t_close, steps=steps,
                 setup_s=t_open - t_start, memory_peak_bytes=peak,
                 stats_open=stats_open, stats_close=session.stats(),
                 spans=spans, device_trace=dtrace)
    if trace:
        win.spans += [(f"{e.cat}/{e.name}", e.ts, e.end)
                      for e in session.tracer.events() if e.ph == "X"]
    return win, session
