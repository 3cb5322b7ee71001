"""Share of the fetches' copy time that ran under other work: of each
waited transfer's copy time (on the card, between two timing events on
the copy stream), the part its first wait found already done
(``hidden_s``) against the part the wait blocked on (``exposed_s``), from
``session.stats()["transfer_clock"]`` (telemetry on), over the window.
Nothing to read where no transfer was waited on in the window."""


def read(win):
    a = win.stats_open.get("transfer_clock")
    b = win.stats_close.get("transfer_clock")
    if a is None or b is None:
        return None
    hidden = b["hidden_s"] - a["hidden_s"]
    exposed = b["exposed_s"] - a["exposed_s"]
    if hidden + exposed <= 0:
        return None
    return 100.0 * hidden / (hidden + exposed)
