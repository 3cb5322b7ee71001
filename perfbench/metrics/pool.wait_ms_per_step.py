"""Host ms a scheduler step spends blocked on the transfer engine: its
consumers' waits on fetches not yet landed (``blocked_s``) and its
submitters' stalls on a full pipeline (``backpressure_s``), both from
``session.stats()["pool"]["transfer"]``, from the window's open to its
close, over the scheduler steps between them. Nothing to read where the
engine ran no transfer in the window."""


def _reading(stats):
    transfer = stats.get("pool", {}).get("transfer")
    steps = stats.get("sched", {}).get("steps")
    if transfer is None or steps is None:
        return None
    return (transfer["issued"],
            transfer["blocked_s"] + transfer["backpressure_s"], steps)


def read(win):
    a, b = _reading(win.stats_open), _reading(win.stats_close)
    if a is None or b is None or b[0] == a[0] or b[2] == a[2]:
        return None
    return 1e3 * (b[1] - a[1]) / (b[2] - a[2])
