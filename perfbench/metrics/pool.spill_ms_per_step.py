"""Host ms a scheduler step spends spilling pages down the pool's tiers:
the session tracer's ``pool/spill`` spans over the window, per step. Each
span is one page's move, from the moment the tier below has room to the
page's landing there, so the spans of a cascade do not nest. Nothing to
read where nothing spills, or where spills are not spans."""

from perfbench.harness.layers import span_ms_per_step


def read(win):
    return span_ms_per_step(win, "pool/spill")
