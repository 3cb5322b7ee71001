"""Bandwidth of the pool's fetches from host memory: the bytes of the
``host->device`` copies over their copy time (on the card, between two
timing events on the copy stream around each copy), from
``session.stats()["transfer_clock"]["pairs"]`` (telemetry on), over the
window. Nothing to read where no page came from the host tier."""


def _pair(stats):
    return (stats.get("transfer_clock") or {}).get("pairs", {}).get(
        "host->device")


def read(win):
    a, b = _pair(win.stats_open), _pair(win.stats_close)
    if b is None:
        return None
    a = a or {"bytes": 0, "device_s": 0.0}
    seconds = b["device_s"] - a["device_s"]
    if seconds <= 0:
        return None
    return (b["bytes"] - a["bytes"]) / seconds / 1e9
