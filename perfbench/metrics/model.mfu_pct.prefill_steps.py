"""``model.mfu_pct`` over the window's steps that prefilled a prompt
alone: the whole step (its prefills and the decode rows beside them), whose
time a new request waits for its first token. Beside
``flash_attention_roofline``: a later change that takes the kernel off the
path can claim a gain there only while this share still bounds it."""

from perfbench.harness.layers import steps_in_window, steps_mfu_pct


def read(win):
    return steps_mfu_pct(win, [s for s in steps_in_window(win)
                               if s.prefills])
