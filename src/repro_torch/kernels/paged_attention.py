"""Paged decode attention: the wrapper of the Hopper kernel in
``csrc/paged_attention.cu``, which replaces the JAX package's Pallas kernel
``repro.kernels.paged_attention.paged_decode_attention_pallas``.

The page table is a device int32 tensor that the kernel reads itself, so one
compiled kernel serves every table length (the reference retraces per
length). :func:`paged_decode_attention_cuda` takes CUDA tensors only;
``PagedKVCache.attend_fused`` calls it on a CUDA device and the plain
version (``ref.paged_decode_attention_ref``) on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES

#: shared memory a block may use on Hopper (bytes)
MAX_SMEM_BYTES = 232448


def paged_decode_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_table: torch.Tensor,
                                k_tail: torch.Tensor, v_tail: torch.Tensor,
                                tail_len: int, *, scale: float,
                                logit_cap: Optional[float] = None
                                ) -> torch.Tensor:
    """q (B,Hq,D), pages (P,B,page,Hkv,D), table (n,) int32, tails
    (B,page,Hkv,D), all contiguous CUDA tensors → (B,Hq,D). Table entries
    must name slots in [0, P); the kernel clamps any other value into range
    (the reference's out-of-range reads clamp too)."""
    tensors = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("k_tail", k_tail), ("v_tail", v_tail))
    for name, t in tensors + (("page_table", page_table),):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in tensors:
        if t.dtype not in DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes "
                            "float32 or bfloat16, the same for every input")
    if page_table.dtype != torch.int32 or page_table.dim() != 1:
        raise TypeError("page_table must be a 1-D int32 tensor")
    b, hq, d = q.shape
    if k_tail.dim() != 4 or k_tail.shape[0] != b or k_tail.shape[3] != d:
        raise ValueError(f"k_tail {tuple(k_tail.shape)} does not match "
                         f"q {tuple(q.shape)}")
    page, hkv = k_tail.shape[1], k_tail.shape[2]
    if v_tail.shape != k_tail.shape:
        raise ValueError("k_tail and v_tail differ in shape")
    if (k_pages.shape != v_pages.shape or k_pages.dim() != 5
            or k_pages.shape[1:] != k_tail.shape):
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match the "
                         f"tail {tuple(k_tail.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    n, n_slots = page_table.shape[0], k_pages.shape[0]
    if n and n_slots == 0:
        raise ValueError("a non-empty page table needs at least one slot")
    if not 0 <= tail_len <= page:
        raise ValueError(f"tail_len {tail_len} outside [0, {page}]")
    if logit_cap is not None and logit_cap <= 0:
        raise ValueError(f"logit_cap must be > 0 or None, got {logit_cap}")
    lib = build.load_library()
    smem = lib.paged_decode_attention_smem_bytes(hq // hkv, page, d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"G={hq // hkv}, page={page}, D={d} need {smem} B "
                         f"of shared memory, more than {MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    if b == 0 or hkv == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), n, n_slots, k_tail.data_ptr(),
            v_tail.data_ptr(), int(tail_len), out.data_ptr(),
            DTYPE_CODES[q.dtype], b, hq, hkv, page, d, float(scale),
            0.0 if logit_cap is None else float(logit_cap), stream)
    build.check(err, "paged_decode_attention_fwd")
    paged_decode_attention_cuda.launches += 1
    return out


#: launches of the kernel in this process (set to 0 to start a count)
paged_decode_attention_cuda.launches = 0
