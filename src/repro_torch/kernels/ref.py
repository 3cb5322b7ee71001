"""Plain PyTorch versions of the kernels.

These compute the same functions as the hand-written CUDA kernels beside
them (``csrc/``), with the same arithmetic as the JAX reference's oracles
(``repro.kernels.ref``). Attention: scores in fp32, masking with the finite
``NEG_INF`` (never ``-inf``: rows that start fully masked would turn into
NaN), one softmax, output in q's type. The SSD scan delegates to the
model's chunked algorithm, as the reference's oracle does. The CPU tests
hold them against the JAX package; on the card they are the yardstick each
kernel is checked against.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

NEG_INF = -2.3819763e38


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return x if cap is None else cap * torch.tanh(x / cap)


def flash_attention_ref(
    q: torch.Tensor,   # (B, Hq, S, D)
    k: torch.Tensor,   # (B, Hkv, T, D)
    v: torch.Tensor,   # (B, Hkv, T, D)
    *,
    scale: float,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, s, d) * scale
    sc = torch.einsum("bkgsd,bktd->bkgst", qf, k.float())
    sc = _softcap(sc, logit_cap)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,       # (B, Hq, D) — one token per sequence
    k: torch.Tensor,       # (B, Hkv, C, D) ring cache
    v: torch.Tensor,       # (B, Hkv, C, D)
    pos: Union[int, torch.Tensor],   # token index just written: () or (B,)
    *,
    scale: float,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """Attention of one query over a ring-buffer cache: slot j holds token
    t_j = pos - ((pos - j) mod C); valid iff t_j >= 0. ``pos`` is one index
    for every row (an int or 0-dim tensor) or one per row ((B,) tensor)."""
    b, hq, d = q.shape
    hkv, c = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d) * scale
    sc = torch.einsum("bkgd,bkcd->bkgc", qf, k.float())
    sc = _softcap(sc, logit_cap)
    j = torch.arange(c, device=q.device)
    p = pos if isinstance(pos, int) else pos.reshape(-1, 1)   # (1|B, 1)
    tj = p - torch.remainder(p - j, c)                        # (C,) or (1|B, C)
    sc = torch.where((tj >= 0).reshape(-1, 1, 1, c), sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgc,bkcd->bkgd", p, v.float())
    return out.reshape(b, hq, d).to(q.dtype)


def paged_attend_gathered(
    q: torch.Tensor,        # (B, Hq, D)
    kp: torch.Tensor,       # (n, B, page, Hkv, D) — pages, already gathered
    vp: torch.Tensor,
    k_tail: torch.Tensor,   # (B, page, Hkv, D)
    v_tail: torch.Tensor,
    tail_len: Union[int, torch.Tensor],
    *,
    scale: float,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """Two-segment merged softmax over ``[pages ++ tail]``: scores per
    segment, the tail masked at ``tail_len``, one concatenated softmax.
    The gather path of ``offload.kvcache`` and the paged oracle below both
    run exactly this, so the two agree bit for bit."""
    b, hq, d = q.shape
    page, hkv = k_tail.shape[1], k_tail.shape[2]
    g = hq // hkv
    n = kp.shape[0]
    k_flat = kp.permute(1, 0, 2, 3, 4).reshape(b, n * page, hkv, d)
    v_flat = vp.permute(1, 0, 2, 3, 4).reshape(b, n * page, hkv, d)
    qf = q.float().reshape(b, hkv, g, d) * scale
    s_pages = torch.einsum("bkgd,btkd->bkgt", qf,
                           k_flat.float()).reshape(b, hq, n * page)
    s_tail = torch.einsum("bkgd,btkd->bkgt", qf,
                          k_tail.float()).reshape(b, hq, page)
    s_pages = _softcap(s_pages, logit_cap)
    s_tail = _softcap(s_tail, logit_cap)
    t_mask = torch.arange(page, device=q.device) < tail_len
    s_tail = torch.where(t_mask[None, None, :], s_tail, NEG_INF)
    s = torch.cat([s_pages, s_tail], dim=-1)
    p = torch.softmax(s, dim=-1)
    v_all = torch.cat([v_flat, v_tail], dim=1)          # (B, T, Hkv, D)
    pf = p.reshape(b, hkv, g, -1)
    out = torch.einsum("bkgt,btkd->bkgd", pf, v_all.float())
    return out.reshape(b, hq, d).to(q.dtype)


def paged_decode_attention_ref(
    q: torch.Tensor,           # (B, Hq, D) — one token per sequence
    k_pages: torch.Tensor,     # (P, B, page, Hkv, D) — page-resident slots
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (n,) int — slots to attend over, in order
    k_tail: torch.Tensor,      # (B, page, Hkv, D) — device tail buffer
    v_tail: torch.Tensor,
    tail_len: Union[int, torch.Tensor],   # valid tokens in the tail
    *,
    scale: float,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over non-contiguous pages + device tail: gathers
    ``k_pages[page_table]`` and runs :func:`paged_attend_gathered`."""
    idx = page_table.long()
    return paged_attend_gathered(q, k_pages[idx], v_pages[idx], k_tail,
                                 v_tail, tail_len, scale=scale,
                                 logit_cap=logit_cap)


def ssd_scan_ref(
    x: torch.Tensor,       # (B, S, H, P) pre-scaled by dt
    a: torch.Tensor,       # (B, S, H) = dt * A (negative)
    b_mat: torch.Tensor,   # (B, S, H, N)
    c_mat: torch.Tensor,   # (B, S, H, N)
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: (y (B,S,H,P), final state (B,H,P,N)), both fp32.
    Delegates to the model's :func:`~repro_torch.models.ssm.ssd_chunked`."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, a, b_mat, c_mat, chunk)
