"""Flash attention (prefill): the wrapper of the Hopper kernels in
``csrc/flash_attention.cu``, which replace the JAX package's Pallas kernel
``repro.kernels.flash_attention.flash_attention_pallas``.

:func:`flash_attention_cuda` takes CUDA tensors in the kernel layout q
(B,Hq,S,D), k/v (B,Hkv,T,D). The model calls it through
``ops.flash_attention``, which takes the model layout and runs the plain
version (``ref.flash_attention_ref``) for tensors on the CPU. The library
picks one of three kernel instances by dtype, head dim and alignment
(``INSTANCES``); each launch is counted under its instance in
``flash_attention_cuda.instances``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES

MAX_HEAD_DIM = 256
#: the kernel instances, by the code the library reports: fp32 FMA; bf16
#: mma.sync (any head dim, unaligned rows); bf16 wgmma fed by TMA (head dim
#: 64, 96, 112 or 128 with 16-byte aligned rows)
INSTANCES = ("fma_f32", "mma_sync", "wgmma")


def _check_inputs(q, k, v, out, window, logit_cap) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad; the flash kernel has "
                             "no backward")
        if t.dtype not in DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes "
                            "float32 or bfloat16, the same for q, k, v")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous "
                             f"(strides {t.stride()})")
    b, hq, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside (0, {MAX_HEAD_DIM}]")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if logit_cap is not None and logit_cap <= 0:
        raise ValueError(f"logit_cap must be > 0 or None, got {logit_cap}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype
                            or out.device != q.device or out.stride(-1) != 1):
        raise ValueError("out must match q's shape, dtype and device, with a "
                         "contiguous head dim")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float, causal: bool = True,
                         window: Optional[int] = None,
                         logit_cap: Optional[float] = None,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel on the current stream. q/k/v/out may be strided
    views (any batch/head/seq strides, unit head-dim stride), so model-layout
    tensors go in without a copy. ``out`` defaults to a new (B,Hq,S,D)."""
    _check_inputs(q, k, v, out, window, logit_cap)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b == 0 or s == 0 or hq == 0:
        return out
    if t == 0:          # no keys: the empty sum, as the plain version gives
        return out.zero_()
    lib = build.load_library()
    instance = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], b, hq, hkv, s, t, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            float(scale), int(bool(causal)),
            -1 if window is None else int(window),
            0.0 if logit_cap is None else float(logit_cap),
            ctypes.byref(instance), stream)
    build.check(err, "flash_attention_fwd")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.instances[INSTANCES[instance.value]] += 1
    return out


#: launches of the kernel in this process (set to 0 to start a count), and
#: the same launches by kernel instance
flash_attention_cuda.launches = 0
flash_attention_cuda.instances = dict.fromkeys(INSTANCES, 0)
