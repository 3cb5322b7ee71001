"""Public kernel wrappers in model layout (the counterpart of
``repro.kernels.ops``), and the kernels' launch counts.

A wrapper runs its plain PyTorch version when the tensors lie on the CPU
and launches the Hopper kernel when they lie on a CUDA device; there is no
fallback from the kernel to the plain version. The kernel-launching
functions count their launches (:func:`launch_counts`), so a run can show
that its main path went through the kernels. The paged-decode kernel takes
the paged cache's own layout, and ``PagedKVCache.attend_fused`` calls
``paged_attention.paged_decode_attention_cuda`` directly.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "launch_counts", "reset_launch_counts"]

_COUNTED = {"flash_attention": flash_attention_cuda,
            "paged_decode_attention": paged_decode_attention_cuda}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    causal: bool = True) -> torch.Tensor:
    """Model-layout flash attention: q (B,S,Hq,D), k/v (B,T,Hkv,D) →
    (B,S,Hq,D). On CUDA the kernel reads the transposed views in place and
    writes straight into a (B,S,Hq,D) output."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cpu":
        out = flash_attention_ref(qt, kt, vt, scale=scale, causal=causal,
                                  window=window, logit_cap=logit_cap)
        return out.transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention_cuda(qt, kt, vt, scale=scale, causal=causal,
                         window=window, logit_cap=logit_cap,
                         out=out.transpose(1, 2))
    return out


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
