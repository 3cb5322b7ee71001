"""Host ms a scheduler step spends in its batched decode, which ends on the
host copy of the sampled tokens: ``sched/decode`` spans over the window,
per step."""

from perfbench.harness.layers import span_ms_per_step


def read(win):
    return span_ms_per_step(win, "sched/decode")
