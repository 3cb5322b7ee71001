"""The flash-attention kernel (``kernels/csrc/flash_attention.cu``) against
its roofline: per traced step, one launch per layer for each prompt it
prefilled (B=1, S=T=prompt length, causal), the bound time from
``counts.flash_counts`` over the launches' device time."""

from perfbench.harness import counts
from perfbench.harness.layers import attention_shape, kernel_roofline


def read(win):
    a = attention_shape(win)

    def launches(step):
        return [counts.flash_counts(1, s, s, a["hq"], a["hkv"], a["d"])
                for s in step.prefills for _ in range(a["layers"])]

    return kernel_roofline(win, "flash_fwd", launches)
