"""A whole run of a cell, as ``run.py`` prints it: the window, its metrics,
the program's state freed, then the output check."""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench.harness import check, layers, serve
from perfbench.harness.devtrace import label_gaps
from perfbench.harness.spec import Cell, metric_specs
from perfbench.harness.stats import window_metrics

GIB = 1 << 30


def _top(d: Dict[str, float], n: int = 10) -> List[List[Any]]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def verdict(cell: Cell, win: serve.Window, seed: int, device: torch.device,
            *, control: bool = False):
    """The output check of a served window against the cell's limits:
    (correct, numbers compared, every number); ``control`` judges the
    float8 control in the program's place."""
    limits = {name: c["limit"] for name, c in cell.layout["check"].items()}
    return check.check(cell.config, cell.layout, win.params, win.served,
                       win.t_close, seed, limits, device,
                       pool=win.stats_close.get("pool"), control=control)


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float, *,
            lead_in_s: Optional[float] = None,
            session_options: Optional[Dict[str, Any]] = None
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the result line's object, the numbers for the earlier lines);
    ``session_options`` are further ``OffloadConfig`` fields (the tests'
    and the calibration tool's way to switch on the program's own
    lower-precision path)."""
    win, session = serve.run(cell, seed, seconds, trace, device, t_start,
                             lead_in_s=lead_in_s,
                             session_options=session_options)
    e2e = window_metrics(win.served, win.t_open, win.t_close)
    e2e["setup_s"] = win.setup_s
    if win.memory_peak_bytes is not None:
        e2e["peak_device_gib"] = win.memory_peak_bytes / GIB
    notes: Dict[str, Any] = dict(e2e)
    notes["steps_in_window"] = len(layers.steps_in_window(win))
    notes["sched"] = {k: v for k, v in win.stats_close["sched"].items()
                      if not isinstance(v, dict)}
    metrics: Dict[str, Dict[str, Any]] = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in metric_specs(cell, kind):
        value = layers.reader(m["name"])(win) if trace else e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info: Dict[str, Any] = {}
    breakdown = None
    dt = win.device_trace
    if dt is not None:
        device_info = {"busy_s": dt.busy_s(), "window_s": dt.window_s}
        notes["trace_offset_drift_s"] = dt.offset_drift_s
        notes["trace_device_events"] = len(dt.events)
        notes["trace_anchors_seen"] = dt.anchors_seen
        breakdown = {"device_ops": _top(dt.time_by_name()),
                     "idle_gaps": _top(label_gaps(dt.idle_gaps(), win.spans))}
    # the program's state goes before the reference runs
    session.close()
    del session
    win.device_trace = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, numbers, info = verdict(cell, win, seed, device)
    notes.update(info, check_s=time.perf_counter() - t_check)
    result: Dict[str, Any] = {
        "correct": bool(correct),
        "attempted": e2e["requests_due"],
        "failed": e2e["requests_failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.entry["chips"],
                   "memory_peak_bytes": win.memory_peak_bytes,
                   **device_info},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = numbers
    return result, notes
