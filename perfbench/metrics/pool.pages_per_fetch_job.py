"""Pages a fetch job carries: of the transfer jobs the pool's
``prefetch_many`` submitted in the window, the pages they carried over
their number, from ``session.stats()["transfer_clock"]``
(``fetch_job_pages`` and ``fetch_jobs``, telemetry on). The scheduler
submits one job per planned layer a step, so in a kv_offload cell it reads
the live rows times a layer's cache leaves. Nothing to read where no job
ran in the window, or where the program keeps no such counter."""


def _reading(stats):
    clock = stats.get("transfer_clock") or {}
    if "fetch_jobs" not in clock:
        return None
    return clock["fetch_jobs"], clock["fetch_job_pages"]


def read(win):
    a, b = _reading(win.stats_open), _reading(win.stats_close)
    if a is None or b is None or b[0] == a[0]:
        return None
    return (b[1] - a[1]) / (b[0] - a[0])
