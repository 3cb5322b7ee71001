"""Bytes the pool moved down a tier (device to host, host to remote) per
token served in the window: the pool's ``bytes_evicted`` counter
(``session.stats()["pool"]``, counted when a spill is issued) from the
window's open to its close, over the tokens stamped in the window."""

from perfbench.harness.stats import window_metrics


def read(win):
    a = win.stats_open.get("pool", {}).get("bytes_evicted")
    b = win.stats_close.get("pool", {}).get("bytes_evicted")
    tokens = window_metrics(win.served, win.t_open, win.t_close)["tokens"]
    if a is None or b is None or not tokens or not win.cell.offload:
        return None
    return (b - a) / tokens
