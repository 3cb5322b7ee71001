"""Public kernel wrappers in model layout (the counterpart of
``repro.kernels.ops``), and the kernels' launch counts.

- :func:`flash_attention`: causal prefill attention, q (B,S,Hq,D) over k/v
  (B,T,Hkv,D);
- :func:`decode_attention`: one query per row over a ring cache, q
  (B,1,Hq,D) over k/v (B,C,Hkv,D) at one ``pos`` for every row or one per
  row;
- :func:`ssd_scan`: the Mamba2 SSD chunked scan, returning y and the final
  state.

A wrapper runs its plain PyTorch version when the tensors lie on the CPU
and launches the Hopper kernel when they lie on a CUDA device; there is no
fallback from the kernel to the plain version. Under a device mesh the
model calls the wrappers on each device's local heads and rows
(``sharding.ops.local_over``), so a one-device mesh launches the same
kernel on the same tensors as no mesh; a ``DTensor`` given to a wrapper
raises. The kernel-launching
functions count their launches (:func:`launch_counts`), so a run can show
that its main path went through the kernels. The paged-decode kernel takes
the paged cache's own layout, and ``PagedKVCache.attend_fused`` calls
``paged_attention.paged_decode_attention_cuda`` directly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import (
    decode_attention_cuda,
    paged_decode_attention_cuda,
)
from repro_torch.kernels.ref import (
    decode_attention_ref,
    flash_attention_ref,
    ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.sharding.ops import is_dtensor

__all__ = ["flash_attention", "decode_attention", "ssd_scan",
           "launch_counts", "reset_launch_counts", "launch_counters",
           "add_launch_counters"]

_COUNTED = {"flash_attention": flash_attention_cuda,
            "paged_decode_attention": paged_decode_attention_cuda,
            "decode_attention": decode_attention_cuda,
            "ssd_scan": ssd_scan_cuda}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    causal: bool = True) -> torch.Tensor:
    """Model-layout flash attention: q (B,S,Hq,D), k/v (B,T,Hkv,D) →
    (B,S,Hq,D). On CUDA the kernel reads the transposed views in place and
    writes straight into a (B,S,Hq,D) output."""
    _refuse_dtensor(q, k, v)
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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Union[int, torch.Tensor], *, scale: float,
                     logit_cap: Optional[float] = None) -> torch.Tensor:
    """Ring-cache decode attention: q (B,1,Hq,D), cache (B,C,Hkv,D) →
    (B,1,Hq,D). ``pos`` is the token index just written: an int or 0-dim
    tensor (every row), or a (B,) tensor (each row at its own index). On
    CUDA the kernel reads the cache in place through its strides, and a
    tensor ``pos`` on the card as a device array."""
    _refuse_dtensor(q, k, v, pos)
    q3 = q[:, 0]
    if q.device.type == "cpu":
        out = decode_attention_ref(q3, k.transpose(1, 2), v.transpose(1, 2),
                                   pos, scale=scale, logit_cap=logit_cap)
    else:
        out = decode_attention_cuda(q3, k, v, pos, scale=scale,
                                    logit_cap=logit_cap)
    return out[:, None]


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan in model layout: x (B,S,H,P), a (B,S,H),
    B/C (B,S,H,N), ``S % chunk == 0`` → (y (B,S,H,P), final state
    (B,H,P,N)), both fp32."""
    _refuse_dtensor(x, a, b_mat, c_mat)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, a, b_mat, c_mat, chunk)
    return ssd_scan_cuda(x, a, b_mat, c_mat, chunk)


def _refuse_dtensor(*ts) -> None:
    """A wrapper takes each device's local tensors: the model hands it
    those through ``sharding.ops.local_over``. A ``DTensor`` would reach
    the launch as a wrapper object, so it is refused here."""
    if any(is_dtensor(t) for t in ts):
        raise TypeError("the kernel wrappers take local tensors; run them "
                        "under sharding.ops.local_over on a mesh")


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def launch_counters() -> Dict[Tuple[str, Optional[str]], int]:
    """Every launch counter: ``(kernel, None)`` the kernel's launches,
    ``(kernel, instance)`` its launches of one instance (flash, SSD)."""
    out: Dict[Tuple[str, Optional[str]], int] = {}
    for name, fn in _COUNTED.items():
        out[(name, None)] = fn.launches
        for inst, n in getattr(fn, "instances", {}).items():
            out[(name, inst)] = n
    return out


def add_launch_counters(delta: Dict[Tuple[str, Optional[str]], int]
                        ) -> None:
    """Add ``delta``, keyed as :func:`launch_counters` keys it, to the
    counters: a CUDA graph's replay launches the kernels it captured
    without calling their wrappers, so it adds what its capture counted."""
    for (name, inst), n in delta.items():
        fn = _COUNTED[name]
        if inst is None:
            fn.launches += n
        else:
            fn.instances[inst] += n


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
    for fn in (flash_attention_cuda, ssd_scan_cuda):
        fn.instances = dict.fromkeys(fn.instances, 0)
