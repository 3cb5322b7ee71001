"""Attention mixers, GQA (sliding windows, logit softcap, RoPE/M-RoPE),
MLA (multi-head latent attention) and whisper's cross-attention:
full-sequence (prefill), chunked prefill against an existing cache, and
single-token decode.

A cross-attention layer's cache also holds the encoder output's keys and
values, ``xk``/``xv`` of (B, n_frames, Hkv, D), written once by the
prefill and read whole (no mask) by every decode step. Non-causal
attention (the encoder's, and every cross-attention) is plain PyTorch on
every device, as it stays XLA in the reference: only causal attention
takes the flash kernel.

MLA caches hold the per-token latent ``ckv`` (B, C, kv_lora_rank) and the
rotated key part ``krope`` (B, C, qk_rope_head_dim), 3-D leaves where
GQA's ``k``/``v`` are 4-D, and every query up-projects the whole latent
ring through ``wukv``, as the reference does. The reference computes MLA
in plain XLA (no Pallas kernel), so the port's MLA is plain PyTorch on
every device.

KV caches for sliding-window layers are ring buffers of capacity
``min(window, max_seq)`` — token ``t`` lives in slot ``t % C``. Where the
JAX reference returns a new cache (and donates the old buffers), the port
writes the cache tensors in place.

Under a device mesh (``sharding.rules.axis_rules``) the points where
``DTensor`` has no strategy of its own go through ``sharding.ops``: the
projections through ``linear``, the head split through ``split_heads``,
every attention core (the kernels' calls included) through
``local_over`` on each device's batch and heads, and the ring writes
(``index_copy_``, ``roll``, indexed assignment) through ``write_local``
on each device's shard, a ring split over its slots gathered first.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import runtime
from repro_torch.models.common import apply_rope, dense_init, rmsnorm, softcap
from repro_torch.sharding.ops import (
    linear,
    local_over,
    replicated,
    split_heads,
    write_local,
)
from repro_torch.sharding.rules import constrain

NEG_INF = -2.3819763e38

#: the dims an attention core is independent along: batch and heads of a
#: (B, S, H, D) tensor (``sharding.ops.local_over``)
_BH = {"b": 0, "h": 2}

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

    def w(*shape):
        return dense_init(st + shape, dtype, device, generator, ax)

    p = {"wq": w(d, hq * hd), "wk": w(d, hkv * hd), "wv": w(d, hkv * hd),
         "wo": w(hq * hd, d)}
    if spec.cross_attn:
        p.update(xwq=w(d, hq * hd), xwk=w(d, hkv * hd), xwv=w(d, hkv * hd),
                 xwo=w(hq * hd, d))
    return p


def init_mla_params(cfg: ModelConfig, dtype: torch.dtype,
                    device: torch.device, generator: torch.Generator,
                    stack: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """MLA's projections; ``q_norm`` and ``kv_norm`` are fp32 whatever
    ``dtype`` is, as in the reference."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    st, ax = tuple(stack), len(stack)

    def w(*shape):
        return dense_init(st + shape, dtype, device, generator, ax)

    def norm(n):
        return torch.zeros(st + (n,), dtype=torch.float32, device=device)

    return {
        "wdq": w(d, m.q_lora_rank),
        "q_norm": norm(m.q_lora_rank),
        "wuq": w(m.q_lora_rank, h * (dn + dr)),
        "wdkv": w(d, m.kv_lora_rank),
        "kv_norm": norm(m.kv_lora_rank),
        "wkr": w(d, dr),
        "wukv": w(m.kv_lora_rank, h * (dn + dv)),
        "wo": w(h * dv, d),
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
                    enc_frames: Optional[int] = None,
                    stack: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    c = attn_cache_len(cfg, spec, max_seq, swa_override)
    st = tuple(stack) + (batch, c)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if spec.mixer == "mla":
        m = cfg.mla
        cache = {"ckv": zeros(*st, m.kv_lora_rank),
                 "krope": zeros(*st, m.qk_rope_head_dim)}
    else:
        cache = {"k": zeros(*st, cfg.n_kv_heads, cfg.head_dim),
                 "v": zeros(*st, cfg.n_kv_heads, cfg.head_dim)}
    if spec.cross_attn:
        if enc_frames is None:
            raise ValueError("a cross-attention layer's cache needs the "
                             "encoder's frame count")
        xs = tuple(stack) + (batch, enc_frames, cfg.n_kv_heads, cfg.head_dim)
        cache["xk"], cache["xv"] = zeros(*xs), zeros(*xs)
    return cache


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
                 positions: torch.Tensor, annotate: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B,S,Hq,D), k/v (B,S,Hkv,D), rotated. ``annotate`` (the full
    forward's) constrains their head sharding, where the reference's
    ``attention_full`` does."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(linear(x, p["wq"]), hq, hd)
    k = split_heads(linear(x, p["wk"]), hkv, hd)
    v = split_heads(linear(x, p["wv"]), hkv, hd)
    if annotate:
        q = constrain(q, ("batch", "seq", "heads", None))
        k = constrain(k, ("batch", "seq", "kv_heads", None))
        v = constrain(v, ("batch", "seq", "kv_heads", None))
    if cfg.rope_mode in ("rope", "mrope"):
        sections = cfg.mrope_sections if cfg.rope_mode == "mrope" else None
        q = apply_rope(q, positions, cfg.rope_theta, sections)
        k = apply_rope(k, positions, cfg.rope_theta, sections)
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
    """Attention of projected q/k/v (B,S,H,D) → (B,S,Hq*D) in ``dtype``,
    on each device's local batch and heads under a mesh."""
    b, s, hq, hd = q.shape
    out = local_over(functools.partial(_attend_core, cfg, window, causal),
                     (q, k, v), (_BH, _BH, _BH), _BH)
    return out.to(dtype).reshape(b, s, hq * hd)


def _attend_core(cfg: ModelConfig, window: Optional[int], causal: bool,
                 q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """(B,S,Hq,D) attention of local tensors. Causal attention on a CUDA
    tensor goes through the flash kernel."""
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
    return out


def attention_full(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                   x: torch.Tensor, positions: torch.Tensor, *,
                   causal: bool = True,
                   swa_override: Optional[int] = None) -> torch.Tensor:
    """Self-attention over a full sequence. Returns (B,S,D)."""
    if spec.mixer == "mla":
        return _mla_full(cfg, p, x, positions)
    q, k, v = _project_qkv(cfg, p, x, positions, annotate=True)
    out = _attend_full(cfg, _window(spec, swa_override), q, k, v, causal,
                       x.dtype)
    return linear(out, p["wo"])


def cross_attention_kv(cfg: ModelConfig, p: Dict, enc_out: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's (B,T,D) keys and values, (B,T,Hkv,D) each."""
    b, t, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return (split_heads(linear(enc_out, p["xwk"]), hkv, hd),
            split_heads(linear(enc_out, p["xwv"]), hkv, hd))


def _cross_attend(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Queries of x (B,S,D) over every frame of k/v (B,T,Hkv,D), no mask,
    scale hd^-1/2 → (B,S,D)."""
    b, s, _ = x.shape
    hq, hd = cfg.n_heads, cfg.head_dim
    q = split_heads(linear(x, p["xwq"]), hq, hd)
    out = local_over(functools.partial(_cross_core, hd), (q, k, v),
                     (_BH, _BH, _BH), _BH)
    return linear(out.to(x.dtype).reshape(b, s, hq * hd), p["xwo"])


def _cross_core(hd: int, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    probs = _masked_softmax(_gqa_scores(q, k) * hd ** -0.5, None)
    return _gqa_out(probs, v)


def cross_attention_full(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                         enc_out: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention over the encoder output (B,T,D). The
    encoder output enters through one view, so its gradient from this
    layer is summed inside the layer (keys and values) before it meets
    the other layers': the same order whether the layer is differentiated
    with the others or as one recomputed stage (``offload.policies``)."""
    k, v = cross_attention_kv(cfg, p, enc_out.view(enc_out.shape))
    return _cross_attend(cfg, p, x, k, v)


def cross_attention_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                           cache: Dict) -> torch.Tensor:
    """One token per row (B,1,D) over every frame of the cached ``xk``/
    ``xv``."""
    return _cross_attend(cfg, p, x, cache["xk"], cache["xv"])


def attention_prefill(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                      x: torch.Tensor, positions: torch.Tensor, cache: Dict,
                      *, swa_override: Optional[int] = None,
                      enc_out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """Full causal attention; also fills the layer KV cache in place.
    Tokens t ∈ [0, S) are written to ring slot t % C. K/V are projected
    once and reused for the cache (the reference projects them twice; the
    values are the same); so are MLA's latent and rotated key. A
    cross-attention layer also writes the encoder output's keys and values
    (``xk``/``xv``), as the reference does here. Returns (out, cache)."""
    if spec.mixer == "mla":
        out, ckv, kr = _mla_full(cfg, p, x, positions, with_latent=True)
        _ring_write_seq(cache["ckv"], ckv.to(cache["ckv"].dtype))
        _ring_write_seq(cache["krope"], kr.to(cache["krope"].dtype))
        return out, cache
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = linear(_attend_full(cfg, _window(spec, swa_override), q, k, v,
                              True, x.dtype), p["wo"])
    _ring_write_seq(cache["k"], k)
    _ring_write_seq(cache["v"], v)
    if spec.cross_attn and enc_out is not None:
        xk, xv = cross_attention_kv(cfg, p, enc_out)
        cache["xk"].copy_(xk)
        cache["xv"].copy_(xv)
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
    Pallas kernel for this function either. An MLA layer writes first and
    attends after (``_mla_prefill_chunk``)."""
    if spec.mixer == "mla":
        return _mla_prefill_chunk(cfg, p, x, offset, positions, valid_len,
                                  cache)
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
    return linear(out, p["wo"]), cache


def _ring_write_seq(buf: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Write a full sequence (B,S,...) into a ring buffer (B,C,...) in
    place: token t -> slot t % C. When S <= C this is a plain prefix
    write. Under a mesh each device writes its shard."""
    write_local(_write_seq, buf, vals)
    return buf


def _write_seq(buf: torch.Tensor, vals: torch.Tensor) -> None:
    c = buf.shape[1]
    s = vals.shape[1]
    if s <= c:
        buf[:, :s] = vals
        return
    # keep the last C tokens, rotated so that token t sits at slot t % C
    start = (s - c) % c
    buf.copy_(torch.roll(vals[:, s - c:], shifts=start, dims=1))


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
    by the host. An MLA layer decodes in plain PyTorch (``_mla_decode``)
    for every form of ``pos``."""
    if spec.mixer == "mla":
        return _mla_decode(cfg, p, x, pos, positions, cache)
    b, _, _ = x.shape
    hq, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x, positions)
    new_k = _ring_write_token(cache["k"], k, pos)
    new_v = _ring_write_token(cache["v"], v, pos)
    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    out = local_over(functools.partial(_decode_core, cfg),
                     (q, new_k, new_v, pos),
                     (_BH, _BH, _BH, {"b": 0} if per_row else None), _BH)
    return linear(out.to(x.dtype).reshape(b, 1, hq * hd), p["wo"]), cache


def _decode_core(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, pos: Pos) -> torch.Tensor:
    """(B,1,Hq,D) attention of one query per row over the written ring
    (local tensors)."""
    if runtime.attention_impl(q.device) == "kernel":
        from repro_torch.kernels import ops as kops
        # the kernel takes one dtype: q in the cache's (the same on the
        # serving path)
        return kops.decode_attention(q.to(k.dtype), k, v, pos,
                                     scale=_scale(cfg),
                                     logit_cap=cfg.attn_logit_softcap)
    scores = _gqa_scores(q, k) * _scale(cfg)            # (B,1,Hq,C)
    scores = softcap(scores, cfg.attn_logit_softcap)
    valid = _ring_valid_mask(pos, k.shape[1], q.device)  # (C,) or (B,C)
    scores = _apply_valid_mask(scores, valid)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v)


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
    continuous-batching case where requests sit at different positions.
    Returns the written ring: ``buf`` itself, or under a mesh that splits
    the ring's slots, the gathered ring, written, whose shards are then
    copied back into ``buf``."""
    full, gathered = replicated(buf, 1)
    write_local(_write_token, full, vals, pos)
    if gathered:
        buf.copy_(full)
    return full


def _write_token(buf: torch.Tensor, vals: torch.Tensor, pos: Pos) -> None:
    c = buf.shape[1]
    vals = vals.to(buf.dtype)
    if isinstance(pos, int):
        buf[:, pos % c] = vals[:, 0]
    elif pos.dim() == 0:
        buf.index_copy_(1, torch.remainder(pos, c).reshape(1).long(), vals)
    else:
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, torch.remainder(pos, c).long()] = vals[:, 0]


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def _mla_query(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The query's no-rope and rotated parts, (B,S,H,dn) and (B,S,H,dr)."""
    m = cfg.mla
    b, s, _ = x.shape
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    qlat = rmsnorm(linear(x, p["wdq"]), p["q_norm"], cfg.norm_eps)
    q = split_heads(linear(qlat, p["wuq"]), cfg.n_heads, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_latent(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tokens' latent (B,S,r) and rotated key part (B,S,dr): what the
    cache holds."""
    ckv = rmsnorm(linear(x, p["wdkv"]), p["kv_norm"], cfg.norm_eps)
    kr = apply_rope(linear(x, p["wkr"])[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0]
    return ckv, kr


def _mla_expand(cfg: ModelConfig, p: Dict, ckv: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up-project a latent (B,T,r) to keys' no-rope part and values,
    (B,T,H,dn) and (B,T,H,dv). A cache in another type than the weights
    (bf16 under fp32 weights) is promoted first, as JAX's ``@`` does."""
    m = cfg.mla
    b, t, _ = ckv.shape
    w = p["wukv"]
    ckv = ckv.to(torch.promote_types(ckv.dtype, w.dtype))
    kv = (ckv @ w.to(ckv.dtype)).reshape(
        b, t, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    return kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]


def _mla_scores(cfg: ModelConfig, qn: torch.Tensor, qr: torch.Tensor,
                kn: torch.Tensor, kr: torch.Tensor) -> torch.Tensor:
    """(B,S,H,T) fp32 scores: the no-rope part per head plus the rotated
    part shared by every head, scaled."""
    m = cfg.mla
    sc = torch.einsum("bshd,bthd->bsht", qn.float(), kn.float())
    sc = sc + torch.einsum("bshd,btd->bsht", qr.float(), kr.float())
    return sc * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def _mla_out(cfg: ModelConfig, p: Dict, probs: torch.Tensor,
             v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, s, h, _ = probs.shape
    out = torch.einsum("bsht,bthd->bshd", probs, v.float())
    out = out.to(dtype).reshape(b, s, h * cfg.mla.v_head_dim)
    return linear(out, p["wo"])


def _mla_full(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              positions: torch.Tensor, *, with_latent: bool = False):
    """Causal MLA over a full sequence; above ``CHUNKED_ATTN_THRESHOLD``
    one query chunk of ``CHUNK_Q`` at a time (the reference's scan).
    Returns (B,S,D), and with ``with_latent`` also the latent and rotated
    key the cache takes."""
    s = x.shape[1]
    qn, qr = _mla_query(cfg, p, x, positions)
    ckv, kr = _mla_latent(cfg, p, x, positions)
    kn, v = _mla_expand(cfg, p, ckv)
    step = CHUNK_Q if s > CHUNKED_ATTN_THRESHOLD else s
    outs = []
    for q0 in range(0, s, step):
        sc = _mla_scores(cfg, qn[:, q0:q0 + step], qr[:, q0:q0 + step], kn,
                         kr)
        mask = make_causal_mask(sc.shape[1], s, None, x.device, offset=q0)
        outs.append(_mla_out(cfg, p, _masked_softmax(sc, mask), v, x.dtype))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return (out, ckv, kr) if with_latent else out


def _mla_prefill_chunk(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                       offset: int, positions: torch.Tensor, valid_len: int,
                       cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """MLA chunk prefill: write the chunk's latent into the cache, then
    attend every chunk query over the whole updated cache (the decode
    path's expand-from-latent, for S queries). Write-then-attend is exact
    because MLA caches are full-length (no sliding window), so a chunk
    never overwrites history a query still needs."""
    c = cache["ckv"].shape[1]
    qn, qr = _mla_query(cfg, p, x, positions)
    ckv_t, kr_t = _mla_latent(cfg, p, x, positions)
    new_ckv = _ring_write_at(cache["ckv"], ckv_t, offset, valid_len)
    new_kr = _ring_write_at(cache["krope"], kr_t, offset, valid_len)
    kn, v = _mla_expand(cfg, p, new_ckv)
    sc = _mla_scores(cfg, qn, qr, kn, new_kr)
    # after the write, ring slot j holds token P - ((P - j) mod C) for the
    # last written position P; causal: visible iff 0 <= t_j <= query pos
    last = offset + valid_len - 1
    dev = x.device
    tj = last - torch.remainder(last - torch.arange(c, device=dev), c)
    qi = offset + torch.arange(x.shape[1], device=dev)
    mask = (tj[None, :] >= 0) & (tj[None, :] <= qi[:, None])      # (S, C)
    probs = _masked_softmax(sc, mask[None, :, None, :])
    return _mla_out(cfg, p, probs, v, x.dtype), cache


def _mla_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor, pos: Pos,
                positions: torch.Tensor, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One token per row against the latent ring, written in place; ``pos``
    an int, a 0-dim or a (B,) tensor as in ``attention_decode``. Every step
    up-projects the whole ring (``ckv @ wukv``), the reference's
    algorithm."""
    c = cache["ckv"].shape[1]
    qn, qr = _mla_query(cfg, p, x, positions)
    ckv_t, kr_t = _mla_latent(cfg, p, x, positions)
    new_ckv = _ring_write_token(cache["ckv"], ckv_t, pos)
    new_kr = _ring_write_token(cache["krope"], kr_t, pos)
    kn, v = _mla_expand(cfg, p, new_ckv)
    sc = _apply_valid_mask(_mla_scores(cfg, qn, qr, kn, new_kr),
                           _ring_valid_mask(pos, c, x.device))
    probs = torch.softmax(sc, dim=-1)
    return _mla_out(cfg, p, probs, v, x.dtype), cache
