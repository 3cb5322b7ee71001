"""Share of the window's batched decode steps that replayed the
scheduler's captured CUDA graph, in percent: from
``session.stats()["sched_clock"]`` (telemetry on), ``decode_replays`` over
``decode_captures`` + ``decode_replays`` + ``decode_eager``. Nothing to
read where no step decoded in the window, or where the program keeps no
such counter."""

KEYS = ("decode_captures", "decode_replays", "decode_eager")


def _reading(stats):
    clock = stats.get("sched_clock") or {}
    if any(k not in clock for k in KEYS):
        return None
    return [clock[k] for k in KEYS]


def read(win):
    a, b = _reading(win.stats_open), _reading(win.stats_close)
    if a is None or b is None:
        return None
    captures, replays, eager = (y - x for x, y in zip(a, b))
    total = captures + replays + eager
    if total <= 0:
        return None
    return 100.0 * replays / total
