"""Host ms a scheduler step spends moving KV pages through the pool:
parking every live row and issuing the next fetches (``sched/park_issue``)
and waiting for and scattering the fetched pages (``sched/collect``), over
the window, per step. Nothing to read in a resident cell."""

from perfbench.harness.layers import span_ms_per_step


def read(win):
    return span_ms_per_step(win, "sched/park_issue", "sched/collect")
