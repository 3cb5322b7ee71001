"""The ring-decode kernel (``kernels/csrc/decode_attention.cu``) against its
roofline: per traced step that decoded, one launch per layer over all
``max_batch`` rows, live rows at their positions and free rows at 0 (the
scheduler decodes them too), counting only each row's valid positions
(``counts.ring_counts``)."""

from perfbench.harness import counts
from perfbench.harness.layers import attention_shape, kernel_roofline


def read(win):
    a = attention_shape(win)
    lay = win.cell.layout

    def launches(step):
        if not step.decode_pos:
            return []
        pos = step.decode_pos + [0] * (lay["max_batch"] - len(step.decode_pos))
        one = counts.ring_counts(pos, lay["max_seq"], a["hq"], a["hkv"], a["d"])
        return [one] * a["layers"]

    return kernel_roofline(win, "ring_decode", launches)
