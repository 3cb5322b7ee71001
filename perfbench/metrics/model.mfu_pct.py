"""The whole model step's share of the chip's bf16 peak while it steps:
the FLOPs of the window's scheduler steps (``perfbench.harness.counts``: 2
x the weight-matrix parameters a token uses, the output head once a
prefill and once a decoded token, attention over each token's context),
over those steps' summed host time x 989 TFLOP/s. Below a cell's knee the
window's FLOPs are the offered load's, so it is the time the steps take
that moves. Free decode rows, padding and dropped expert capacity are not
model FLOPs."""

from perfbench.harness.layers import steps_in_window, steps_mfu_pct


def read(win):
    return steps_mfu_pct(win, steps_in_window(win))
