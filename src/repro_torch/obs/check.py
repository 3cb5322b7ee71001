"""Trace-file schema checker of the telemetry subsystem (the port's copy of
``repro.obs.check``).

Validates that an exported trace is (a) well-formed Chrome trace-event
JSON that Perfetto will open, and (b) consistent with the repo's span
schema: every complete span has a non-negative duration (end >= start),
and every transfer handle's events are ordered execution-start <=
complete <= wait-resolution. (The transfer span covers execution only —
queue time shows up as ``transfer.backpressure`` — so a blocked wait may
legitimately *start* before its transfer span does; wait-start ordering
is only an invariant for overlapped waits.) On CUDA a transfer span is the
copy's interval on the copy stream, mapped from the device's timer onto
the host clock through an anchor, while the wait is read off the host
clock: the two are compared within ``_EPS_US``. Run as

    PYTHONPATH=src python -m repro_torch.obs.check TRACE.json

Exit status 0 = valid; 1 = violations (printed one per line).
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List

from repro_torch.obs.overlap import (
    SCHED_CAT, STEP_SPAN, TRANSFER_CAT, TRANSFER_SPAN, WAIT_SPAN,
)

__all__ = ["validate_events", "validate_file"]

_PHASES = {"X", "i", "M"}
#: tolerance of the ordering checks (microseconds): float slop between
#: threads' perf_counter readings and, on CUDA, the error of the anchor that
#: maps a copy's timing events onto the host clock (``CopyClock``). On an
#: NVIDIA H100 under torch.profiler the copy spans ended 87-96 us after the
#: profiler's record of the same copies with the profiler's clock mapped by
#: a spin kernel's launch (which puts its events early by the launch), and
#: 66-75 us before it with the clock mapped by a host reading inside a
#: ``record_function`` range: the profiler places the anchor's error no
#: closer than that 162 us between its two mappings. What this checker asks
#: (a wait ends no earlier than its transfer) held in the session traces
#: that ``chip_smoke.py`` checks on the card
_EPS_US = 50.0


def validate_events(obj: Any) -> List[str]:
    """Validate a parsed Chrome trace object. Returns violation messages
    (empty = valid)."""
    errors: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' array"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be an array"]
    transfers: Dict[int, Dict[str, float]] = {}
    waits: Dict[int, Dict[str, Any]] = {}
    n_spans = 0
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: event must be an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}: ph {ph!r} not in {sorted(_PHASES)}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: missing/empty 'name'")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"{where}: 'ts' must be a number")
            continue
        if not isinstance(ev.get("pid"), int) or not isinstance(
                ev.get("tid"), int):
            errors.append(f"{where}: 'pid'/'tid' must be integers")
        if ph == "X":
            n_spans += 1
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)):
                errors.append(f"{where}: complete span missing 'dur'")
                continue
            if dur < 0:
                errors.append(f"{where}: span end < start (dur {dur})")
                continue
            args = ev.get("args", {})
            if (ev.get("cat") == TRANSFER_CAT
                    and ev["name"] in (TRANSFER_SPAN, WAIT_SPAN)):
                if "seq" not in args:
                    errors.append(f"{where}: {ev['name']} span missing "
                                  "args.seq")
                    continue
                rec = {"ts": float(ts), "end": float(ts) + float(dur),
                       "where": where}
                if ev["name"] == TRANSFER_SPAN:
                    # a job that reads several tiers has a span per tier:
                    # it completes with the last
                    seq = int(args["seq"])
                    if seq not in transfers or \
                            transfers[seq]["end"] < rec["end"]:
                        transfers[seq] = rec
                else:
                    rec["hit"] = bool(args.get("hit"))
                    waits[int(args["seq"])] = rec
            if (ev.get("cat") == SCHED_CAT and ev["name"] == STEP_SPAN
                    and "step" not in args):
                errors.append(f"{where}: sched step span missing args.step")
    # per-handle ordering: execution-start <= complete (span dur >= 0,
    # checked) and the wait resolves no earlier than the transfer
    # completes — a blocked wait ends at completion, an overlapped wait
    # starts after it. A blocked wait may START before the transfer span
    # (the span excludes queue time), so wait-start is only checked for
    # overlapped waits.
    for seq, w in waits.items():
        t = transfers.get(seq)
        if t is None:
            continue   # transfer span evicted from the ring before export
        if w["end"] + _EPS_US < t["end"]:
            errors.append(
                f"{w['where']}: wait for seq {seq} resolved at "
                f"{w['end']:.1f}us before its transfer completed at "
                f"{t['end']:.1f}us")
        if w["hit"] and w["ts"] + _EPS_US < t["end"]:
            errors.append(
                f"{w['where']}: overlapped wait for seq {seq} started "
                "before the transfer completed")
    if n_spans == 0:
        errors.append("trace contains no complete spans")
    return errors


def validate_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: not readable JSON ({e})"]
    return validate_events(obj)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.check",
        description="validate an exported Chrome trace-event file against "
                    "the repro_torch.obs span schema")
    ap.add_argument("trace", help="path to a trace JSON file")
    args = ap.parse_args(argv)
    errors = validate_file(args.trace)
    for e in errors:
        print(f"SCHEMA: {e}")
    if errors:
        return 1
    with open(args.trace) as f:
        n = len(json.load(f)["traceEvents"])
    print(f"{args.trace}: valid Chrome trace ({n} events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
