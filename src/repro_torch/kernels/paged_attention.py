"""Decode attention: the wrappers of the two Hopper kernels that replace
the JAX package's Pallas kernels of ``repro.kernels.paged_attention``.

- :func:`paged_decode_attention_cuda` (``csrc/paged_attention.cu``)
  replaces ``paged_decode_attention_pallas``: one query over pool pages
  plus the device tail, split across blocks and merged in the same launch.
  The page table is a device int32 tensor that the kernel reads itself, so
  one compiled kernel serves every table length (the reference retraces
  per length). ``PagedKVCache.attend_fused`` calls
  it on a CUDA device and the plain version
  (``ref.paged_decode_attention_ref``) on the CPU.
- :func:`decode_attention_cuda` (``csrc/decode_attention.cu``) replaces
  ``decode_attention_pallas``: one query over a ring cache, read in the
  model's (B,C,Hkv,D) layout through its strides, at a host-scalar ``pos``
  or at per-row positions held in a device tensor, split across blocks (:func:`ring_split`) and merged in the same launch.
  ``ops.decode_attention`` calls it on a CUDA device and
  ``ref.decode_attention_ref`` on the CPU.

Both take CUDA tensors only, and share their split-K machinery
(``csrc/decode_split.cuh``), split sizes (:func:`ring_split`) and ticket
buffer.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPE_CODES, MAX_SMEM_BYTES


#: blocks the split-K kernels aim to put on each SM (a block is 4 warps)
RING_BLOCKS_PER_SM = 8
#: per device: one int32 ticket per (row, kv head), zero between launches;
#: shared by the ring and paged kernels, which run one after the other on
#: one stream and each leave their tickets at 0
_tickets: Dict[int, torch.Tensor] = {}
_sm_count: Dict[int, int] = {}


def ring_split(rows: int, c: int, n_sm: int) -> int:
    """Token rows per block of the split-K kernels: a multiple of 16, small
    enough that ``rows`` x splits blocks put about ``RING_BLOCKS_PER_SM`` on
    each of ``n_sm`` SMs (phi3's decode, 128 rows x kv heads over C=576 ring
    slots, or over 16 pages of 32 and the tail's 32, on 132 SMs: 9 splits
    of 64)."""
    want = -(-RING_BLOCKS_PER_SM * n_sm // max(rows, 1))
    per = -(-c // want)
    return max(16, -(-per // 16) * 16)


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    buf = _tickets.get(idx)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[idx] = buf
    return buf


def _n_sm(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


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
    (the reference's out-of-range reads clamp too). The (n + 1) * page
    token rows (the pages, then the tail) are split across blocks
    (:func:`ring_split`) and merged in the same launch, through the ticket
    buffer the ring kernel uses: launches from two streams at once must not
    overlap."""
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
    tokens = (n + 1) * page
    split = ring_split(b * hkv, tokens, _n_sm(q.device))
    n_split = -(-tokens // split)
    g = hq // hkv
    lib = build.load_library()
    smem = lib.paged_decode_attention_smem_bytes(DTYPE_CODES[q.dtype], g, d,
                                                 split, n_split)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"G={g}, D={d}, split {split} need {smem} B of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    if b == 0 or hkv == 0 or d == 0:
        return out
    # each split's (m, l, acc) per query row; one split writes no partials
    part = (torch.empty(b * hkv * n_split * g * (d + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    tickets = _ticket_buffer(q.device, b * hkv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), n, n_slots, k_tail.data_ptr(),
            v_tail.data_ptr(), int(tail_len), out.data_ptr(),
            DTYPE_CODES[q.dtype], b, hq, hkv, page, d, float(scale),
            0.0 if logit_cap is None else float(logit_cap), split,
            None if part is None else part.data_ptr(), tickets.data_ptr(),
            stream)
    build.check(err, "paged_decode_attention_fwd")
    paged_decode_attention_cuda.launches += 1
    return out


#: launches of the kernel in this process (set to 0 to start a count)
paged_decode_attention_cuda.launches = 0


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: Union[int, torch.Tensor], *, scale: float,
                          logit_cap: Optional[float] = None) -> torch.Tensor:
    """q (B,Hq,D) with contiguous heads, ring caches k/v (B,C,Hkv,D) with a
    unit head-dim stride (any other strides, the same for k and v), ``pos``
    the token index just written → (B,Hq,D). ``pos`` is an int or a 0-dim
    CPU tensor (every row at that index, a host scalar), or an integer
    tensor on q's device: 0-dim (every row) or (B,) (each row at its own
    index, as continuous batching decodes). A device tensor is handed to
    the kernel as a device int32 array that each block reads at its row;
    the host never reads it, so the call does not synchronize. :func:`ring_split` sets the slots per block from
    the shape and the card's SM count, whatever the positions. The ticket
    buffer is shared by every launch on a device: launches from two
    streams at once must not overlap."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")
        if t.dtype not in DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes "
                            "float32 or bfloat16, the same for q, k, v")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B,Hq,D) and k/v (B,C,Hkv,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, hq, d = q.shape
    c, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.stride(2) != 1 or q.stride(1) != d or k.stride(3) != 1 \
            or k.stride() != v.stride():
        raise ValueError("q's heads and the head dims must be contiguous, "
                         f"and k and v strided alike (strides q {q.stride()}"
                         f", k {k.stride()}, v {v.stride()})")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if c == 0:
        raise ValueError("the ring cache has no slots")
    pos_rows = None
    if isinstance(pos, torch.Tensor) and pos.dim() == 0 \
            and pos.device.type == "cpu":
        pos = int(pos)     # a host scalar: reading it waits for nothing
    if isinstance(pos, torch.Tensor):
        if pos.device != q.device:
            raise ValueError(f"pos must lie on {q.device}, got {pos.device}")
        if pos.dtype.is_floating_point or pos.dtype == torch.bool \
                or pos.dim() > 1 or (pos.dim() == 1 and pos.shape[0] != b):
            raise ValueError(f"pos must be an integer scalar or ({b},) "
                             f"tensor, got {pos.dtype} {tuple(pos.shape)}")
        pos_rows = pos.to(torch.int32).expand(b).contiguous()
        pos = 0
    if logit_cap is not None and logit_cap <= 0:
        raise ValueError(f"logit_cap must be > 0 or None, got {logit_cap}")
    split = ring_split(b * hkv, c, _n_sm(q.device))
    n_split = -(-c // split)
    g = hq // hkv
    lib = build.load_library()
    smem = lib.decode_attention_smem_bytes(DTYPE_CODES[q.dtype], g, d, split,
                                           n_split)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"G={g}, D={d}, split {split} need {smem} B of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    if b == 0 or d == 0:
        return out
    # each split's (m, l, acc) per query row; one split writes no partials
    part = (torch.empty(b * hkv * n_split * g * (d + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    tickets = _ticket_buffer(q.device, b * hkv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], int(pos),
            None if pos_rows is None else pos_rows.data_ptr(), b, hq, hkv, c,
            d, q.stride(0),
            *k.stride()[:3], float(scale),
            0.0 if logit_cap is None else float(logit_cap), split,
            None if part is None else part.data_ptr(), tickets.data_ptr(),
            stream)
    build.check(err, "decode_attention_fwd")
    decode_attention_cuda.launches += 1
    return out


#: launches of the kernel in this process (set to 0 to start a count)
decode_attention_cuda.launches = 0
