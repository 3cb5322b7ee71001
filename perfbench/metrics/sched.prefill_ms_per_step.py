"""Host ms a scheduler step spends admitting and prefilling: the session
tracer's ``sched/admit_prefill`` spans over the window, per step."""

from perfbench.harness.layers import span_ms_per_step


def read(win):
    return span_ms_per_step(win, "sched/admit_prefill")
