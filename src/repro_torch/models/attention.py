"""GQA attention mixer: full-sequence (prefill), chunked prefill against
an existing cache, and single-token decode, with sliding windows, logit
softcap and RoPE.

KV caches for sliding-window layers are ring buffers of capacity
``min(window, max_seq)`` — token ``t`` lives in slot ``t % C``. Where the
JAX reference returns a new cache (and donates the old buffers), the port
writes the cache tensors in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import runtime
from repro_torch.models.common import apply_rope, dense_init, softcap

NEG_INF = -2.3819763e38

Pos = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# Parameter init / cache layout
# ---------------------------------------------------------------------------


def init_attn_params(cfg: ModelConfig, spec: LayerSpec, dtype: torch.dtype,
                     device: torch.device, generator: torch.Generator,
                     stack: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    st, ax = tuple(stack), len(stack)
    return {
        "wq": dense_init(st + (d, hq * hd), dtype, device, generator, ax),
        "wk": dense_init(st + (d, hkv * hd), dtype, device, generator, ax),
        "wv": dense_init(st + (d, hkv * hd), dtype, device, generator, ax),
        "wo": dense_init(st + (hq * hd, d), dtype, device, generator, ax),
    }


def attn_cache_len(cfg: ModelConfig, spec: LayerSpec, max_seq: int,
                   swa_override: Optional[int] = None) -> int:
    window = spec.window
    if swa_override is not None and spec.mixer in ("attn",) and window is None:
        window = swa_override
    if window is None:
        return max_seq
    return min(window, max_seq)


def init_attn_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                    max_seq: int, dtype: torch.dtype, device: torch.device,
                    swa_override: Optional[int] = None,
                    stack: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    c = attn_cache_len(cfg, spec, max_seq, swa_override)
    shape = tuple(stack) + (batch, c, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Score computation (GQA aware)
# ---------------------------------------------------------------------------


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,Hq,D), k: (B,T,Hkv,D) -> scores (B,S,Hq,T) in fp32."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, s, hkv, g, d)
    sc = torch.einsum("bskgd,btkd->bskgt", qf, k.float())
    return sc.reshape(b, s, hq, k.shape[1])


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,S,Hq,T), v: (B,T,Hkv,Dv) -> (B,S,Hq,Dv)."""
    b, s, hq, t = probs.shape
    hkv = v.shape[2]
    g = hq // hkv
    pf = probs.reshape(b, s, hkv, g, t)
    out = torch.einsum("bskgt,btkd->bskgd", pf, v.float())
    return out.reshape(b, s, hq, v.shape[-1])


def _masked_softmax(scores: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    return torch.softmax(scores, dim=-1)


def make_causal_mask(s: int, t: int, window: Optional[int],
                     device: torch.device, offset: int = 0) -> torch.Tensor:
    """(1,S,1,T) mask: query i (global position offset+i) may see key j<=i
    within the window."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m[None, :, None, :]


# above this length the plain path attends one query chunk at a time, so the
# transient scores are (B, CHUNK_Q, Hq, T) instead of (B, S, Hq, T)
CHUNKED_ATTN_THRESHOLD = 2048
CHUNK_Q = 512


def _plain_causal_attention(q, k, v, scale, window, cap) -> torch.Tensor:
    s = q.shape[1]
    outs = []
    step = CHUNK_Q if s > CHUNKED_ATTN_THRESHOLD else s
    for q0 in range(0, s, step):
        qb = q[:, q0:q0 + step]
        scores = softcap(_gqa_scores(qb, k) * scale, cap)
        mask = make_causal_mask(qb.shape[1], k.shape[1], window, q.device,
                                offset=q0)
        outs.append(_gqa_out(_masked_softmax(scores, mask), v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Full-sequence attention (prefill)
# ---------------------------------------------------------------------------


def _project_qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cfg.rope_mode == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scale(cfg: ModelConfig) -> float:
    return cfg.query_scale if cfg.query_scale is not None \
        else cfg.head_dim ** -0.5


def _window(spec: LayerSpec, swa_override: Optional[int]) -> Optional[int]:
    if swa_override is not None and spec.window is None:
        return swa_override
    return spec.window


def _attend_full(cfg: ModelConfig, window: Optional[int], q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, causal: bool,
                 dtype: torch.dtype) -> torch.Tensor:
    """Attention of projected q/k/v (B,S,H,D) → (B,S,Hq*D) in ``dtype``.
    Causal attention on a CUDA tensor goes through the flash kernel."""
    b, s, hq, hd = q.shape
    scale = _scale(cfg)
    if causal and runtime.attention_impl(q.device) == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, scale=scale, window=window,
                                   logit_cap=cfg.attn_logit_softcap,
                                   causal=True)
    elif causal:
        out = _plain_causal_attention(q, k, v, scale, window,
                                      cfg.attn_logit_softcap)
    else:
        scores = softcap(_gqa_scores(q, k) * scale, cfg.attn_logit_softcap)
        out = _gqa_out(_masked_softmax(scores, None), v)
    return out.to(dtype).reshape(b, s, hq * hd)


def attention_full(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                   x: torch.Tensor, positions: torch.Tensor, *,
                   causal: bool = True,
                   swa_override: Optional[int] = None) -> torch.Tensor:
    """Self-attention over a full sequence. Returns (B,S,D)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = _attend_full(cfg, _window(spec, swa_override), q, k, v, causal,
                       x.dtype)
    return out @ p["wo"]


def attention_prefill(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                      x: torch.Tensor, positions: torch.Tensor, cache: Dict,
                      *, swa_override: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """Full causal attention; also fills the layer KV cache in place.
    Tokens t ∈ [0, S) are written to ring slot t % C. K/V are projected
    once and reused for the cache (the reference projects them twice; the
    values are the same). Returns (out, cache)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = _attend_full(cfg, _window(spec, swa_override), q, k, v, True,
                       x.dtype) @ p["wo"]
    _ring_write_seq(cache["k"], k)
    _ring_write_seq(cache["v"], v)
    return out, cache


def _ring_write_at(buf: torch.Tensor, vals: torch.Tensor, offset: int,
                   valid_len: int) -> torch.Tensor:
    """Write a chunk (B,S,...) into a ring buffer (B,C,...) in place at an
    arbitrary start: token ``offset + i`` -> slot ``(offset + i) % C``.
    Only the first ``valid_len`` tokens are real (the rest pad a final
    partial chunk) and only they are written, so slots that still hold live
    earlier tokens of a windowed layer are not clobbered. When more than C
    tokens are valid only the last C land (unique slots), as in
    ``_ring_write_seq``."""
    c = buf.shape[1]
    idx = torch.arange(max(0, valid_len - c), valid_len, device=buf.device)
    buf[:, torch.remainder(offset + idx, c)] = vals[:, idx].to(buf.dtype)
    return buf


# ---------------------------------------------------------------------------
# Chunked prefill (a chunk attends over [cache ++ chunk] at its offset)
# ---------------------------------------------------------------------------


def attention_prefill_chunk(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                            x: torch.Tensor, offset: int,
                            positions: torch.Tensor, valid_len: int,
                            cache: Dict, *,
                            swa_override: Optional[int] = None
                            ) -> Tuple[torch.Tensor, Dict]:
    """One prefill chunk x (B,S,D) at global position ``offset`` against an
    existing cache: queries attend over ``[cache ++ chunk]`` with per-query
    causal (and sliding-window) masks, then the chunk's K/V are written
    into the cache in place at slots ``(offset + i) % C``. Returns
    (out, cache).

    Two segments, one softmax: (a) the prior cache, read *before* the
    write, so a windowed layer whose chunk wraps the ring keeps its
    in-window history — slot j holds token h_j = (offset-1) -
    ((offset-1-j) mod C) (floor mod), valid while h_j >= 0 and in the
    query's window; (b) the chunk itself, causal at a shared offset. Padded
    tail tokens (``i >= valid_len``) are neither attended by a valid query
    nor written; their output rows are garbage the caller discards. Masks
    use the finite ``NEG_INF``. ``offset`` and ``valid_len`` are Python
    ints. The plain path runs on every device: the JAX package has no
    Pallas kernel for this function either."""
    b, s, _ = x.shape
    hq, hd = cfg.n_heads, cfg.head_dim
    c = cache["k"].shape[1]
    dev = x.device
    q, k, v = _project_qkv(cfg, p, x, positions)
    window = _window(spec, swa_override)
    scale = _scale(cfg)
    qi = offset + torch.arange(s, device=dev)              # global query pos
    j = torch.arange(c, device=dev)
    hj = (offset - 1) - torch.remainder(offset - 1 - j, c)  # cached token ids
    m_hist = ((hj >= 0) & (offset > 0)).expand(s, c)
    ii = torch.arange(s, device=dev)
    m_chunk = (ii[None, :] <= ii[:, None]) & (ii[None, :] < valid_len)
    if window is not None:
        m_hist = m_hist & (hj[None, :] > qi[:, None] - window)
        m_chunk = m_chunk & (ii[None, :] > ii[:, None] - window)
    sc_hist = _gqa_scores(q, cache["k"]) * scale           # (B,S,Hq,C)
    sc_chunk = _gqa_scores(q, k) * scale                   # (B,S,Hq,S)
    scores = softcap(torch.cat([sc_hist, sc_chunk], dim=-1),
                     cfg.attn_logit_softcap)
    mask = torch.cat([m_hist, m_chunk], dim=-1)            # (S, C+S)
    probs = _masked_softmax(scores, mask[None, :, None, :])
    v_all = torch.cat([cache["v"], v.to(cache["v"].dtype)], dim=1)
    out = _gqa_out(probs, v_all).to(x.dtype).reshape(b, s, hq * hd)
    _ring_write_at(cache["k"], k, offset, valid_len)
    _ring_write_at(cache["v"], v, offset, valid_len)
    return out @ p["wo"], cache


def _ring_write_seq(buf: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Write a full sequence (B,S,...) into a ring buffer (B,C,...) in
    place: token t -> slot t % C. When S <= C this is a plain prefix
    write."""
    c = buf.shape[1]
    s = vals.shape[1]
    if s <= c:
        buf[:, :s] = vals
        return buf
    # keep the last C tokens, rotated so that token t sits at slot t % C
    start = (s - c) % c
    buf.copy_(torch.roll(vals[:, s - c:], shifts=start, dims=1))
    return buf


# ---------------------------------------------------------------------------
# Decode (single token vs cache)
# ---------------------------------------------------------------------------


def _rope_positions(pos: Pos, b: int, device: torch.device) -> torch.Tensor:
    """(B, 1) rope positions of the token being decoded."""
    if isinstance(pos, int):
        return torch.full((b, 1), pos, dtype=torch.int32, device=device)
    if pos.dim() == 0:
        return pos.to(torch.int32).expand(b).reshape(b, 1)
    return pos.to(torch.int32)[:, None]


def attention_decode(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                     x: torch.Tensor, pos: Pos, positions: torch.Tensor,
                     cache: Dict, *, swa_override: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """One token per row, x (B,1,D). ``pos`` is the index being written: a
    Python int or 0-dim tensor (every row at the same index), or a (B,)
    tensor (each row at its own index, as the continuous scheduler
    decodes). The cache is updated in place. Under ``"kernel"`` (a CUDA
    tensor) the attention goes through the ring-decode kernel for every
    form of ``pos``; a tensor ``pos`` reaches it on the device, never read
    by the host."""
    b, _, _ = x.shape
    hq, hd = cfg.n_heads, cfg.head_dim
    c = cache["k"].shape[1]
    q, k, v = _project_qkv(cfg, p, x, positions)
    new_k = _ring_write_token(cache["k"], k, pos)
    new_v = _ring_write_token(cache["v"], v, pos)
    if runtime.attention_impl(x.device) == "kernel":
        from repro_torch.kernels import ops as kops
        # the kernel takes one dtype: q in the cache's (the same on the
        # serving path)
        out = kops.decode_attention(q.to(new_k.dtype), new_k, new_v, pos,
                                    scale=_scale(cfg),
                                    logit_cap=cfg.attn_logit_softcap)
        return out.to(x.dtype).reshape(b, 1, hq * hd) @ p["wo"], cache
    scores = _gqa_scores(q, new_k) * _scale(cfg)        # (B,1,Hq,C)
    scores = softcap(scores, cfg.attn_logit_softcap)
    valid = _ring_valid_mask(pos, c, x.device)          # (C,) or (B,C)
    scores = _apply_valid_mask(scores, valid)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, new_v).to(x.dtype).reshape(b, 1, hq * hd)
    return out @ p["wo"], cache


def _ring_valid_mask(pos: Pos, c: int, device: torch.device) -> torch.Tensor:
    """Which ring slots hold live tokens once token ``pos`` is written.

    Slot j holds token t_j = pos - ((pos - j) mod C); valid iff t_j >= 0.
    For a full (non-ring) cache this reduces to j <= pos. ``pos`` may be a
    scalar (uniform batch) → (C,), or per-row (B,) → (B, C).
    """
    j = torch.arange(c, device=device)
    p = pos if isinstance(pos, int) else pos[..., None]
    t = p - torch.remainder(p - j, c)
    return t >= 0


def _apply_valid_mask(scores: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Mask decode scores (B,1,H,C) with a (C,) or per-row (B,C) mask."""
    if valid.dim() == 1:
        valid = valid[None, None, None, :]
    else:
        valid = valid[:, None, None, :]
    return torch.where(valid, scores, NEG_INF)


def _ring_write_token(buf: torch.Tensor, vals: torch.Tensor,
                      pos: Pos) -> torch.Tensor:
    """Write one token's entries (B,1,...) into the ring buffer (B,C,...)
    in place. A scalar ``pos`` writes every row at slot ``pos % C``; a (B,)
    ``pos`` writes row i at its own slot ``pos[i] % C`` — the
    continuous-batching case where requests sit at different positions."""
    c = buf.shape[1]
    vals = vals.to(buf.dtype)
    if isinstance(pos, int):
        buf[:, pos % c] = vals[:, 0]
    elif pos.dim() == 0:
        buf.index_copy_(1, torch.remainder(pos, c).reshape(1).long(), vals)
    else:
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, torch.remainder(pos, c).long()] = vals[:, 0]
    return buf
