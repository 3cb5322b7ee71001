"""Segment-stacked transformer: init, forward, prefill, chunked prefill
and decode.

Parameters of each repeated layer pattern are stacked along a leading
``repeats`` dimension, exactly as the JAX reference lays them out
(``params["segments"][i]["p0"]["mixer"]["wq"]`` is (repeats, d, Hq·hd)), so
the reference's parameters load leaf by leaf. A Python loop over the repeats
dimension takes the place of ``lax.scan``; each layer sees views into the
stacked tensors, so KV caches (same stacked layout) are written in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.common import apply_norm, embed_init, norm_params, softcap


def _index(tree: Dict, r: int) -> Dict:
    """Layer ``r`` of a stacked tree: views, no copies."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype, device: torch.device) -> Dict:
    blocks.check_supported(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init((cfg.padded_vocab, cfg.d_model), dtype, device,
                            generator),
        "final_norm": norm_params(cfg, device),
        "segments": [],
    }
    for seg in cfg.segments:
        params["segments"].append({
            f"p{i}": blocks.init_layer_params(cfg, spec, dtype, device,
                                              generator, (seg.repeats,))
            for i, spec in enumerate(seg.pattern)})
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init((cfg.d_model, cfg.padded_vocab), dtype,
                                       device, generator)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype, device: torch.device,
               swa_override: Optional[int] = None) -> Dict:
    """Stacked per-segment caches mirroring the parameter layout."""
    blocks.check_supported(cfg)
    return {"segments": [
        {f"p{i}": blocks.init_layer_cache(cfg, spec, batch, max_seq, dtype,
                                          device, swa_override=swa_override,
                                          stack=(seg.repeats,))
         for i, spec in enumerate(seg.pattern)}
        for seg in cfg.segments]}


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params: Dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        # the constant is rounded to x's type first, as the reference does
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def final_logits(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    logits = softcap(logits.float(), cfg.final_logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        # padded vocab: pad columns never win softmax/argmax
        pad = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(pad, logits, -1e30)
    return logits


def _default_positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None, :].expand(b, s)


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            swa_override: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits, aux_loss)."""
    if positions is None:
        positions = _default_positions(tokens)
    x = embed_tokens(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg, seg_params in zip(cfg.segments, params["segments"]):
        for r in range(seg.repeats):
            layer = _index(seg_params, r)
            for i, spec in enumerate(seg.pattern):
                x, a = blocks.apply_layer(cfg, spec, layer[f"p{i}"], x,
                                          positions,
                                          swa_override=swa_override)
                aux = aux + a
    return final_logits(cfg, params, x), aux


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            cache: Dict, *, positions: Optional[torch.Tensor] = None,
            swa_override: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Forward over the prompt; fills ``cache`` in place. Returns
    (last-token logits (B,1,V), cache)."""
    if positions is None:
        positions = _default_positions(tokens)
    x = embed_tokens(cfg, params, tokens)
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"],
                                          cache["segments"]):
        for r in range(seg.repeats):
            layer, layer_cache = _index(seg_params, r), _index(seg_cache, r)
            for i, spec in enumerate(seg.pattern):
                x, _, _ = blocks.apply_layer_prefill(
                    cfg, spec, layer[f"p{i}"], x, positions,
                    layer_cache[f"p{i}"], swa_override=swa_override)
    return final_logits(cfg, params, x[:, -1:, :]), cache


def prefill_chunk(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                  offset: int, valid_len: int, cache: Dict, *,
                  swa_override: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Cache-aware prefill of one prompt chunk (B,S) at global position
    ``offset``, of which the first ``valid_len`` tokens are real: each
    layer's chunk attends over ``[cache ++ chunk]``, so prefilling a prompt
    chunk by chunk leaves the cache a whole-prompt ``prefill`` would.
    Returns (logits of the last valid token (B,1,V), cache), the cache
    written in place."""
    b, s = tokens.shape
    positions = offset + _default_positions(tokens)
    x = embed_tokens(cfg, params, tokens)
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"],
                                          cache["segments"]):
        for r in range(seg.repeats):
            layer, layer_cache = _index(seg_params, r), _index(seg_cache, r)
            for i, spec in enumerate(seg.pattern):
                x, _, _ = blocks.apply_layer_prefill_chunk(
                    cfg, spec, layer[f"p{i}"], x, offset, positions,
                    valid_len, layer_cache[f"p{i}"],
                    swa_override=swa_override)
    last = x[:, valid_len - 1:valid_len]
    return final_logits(cfg, params, last), cache


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                token: torch.Tensor, pos: attn.Pos, *,
                swa_override: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One autoregressive step. Returns (logits (B,1,V), cache).

    ``pos`` may be a scalar (an int or 0-dim tensor: every row writes the
    same index) or a (B,) tensor (continuous batching: each row sits at its
    own position; rows are independent). The reference threads the stacked
    cache through its layer scan as a donated carry; here each layer writes
    its slice of the stacked cache in place."""
    b = token.shape[0]
    positions = attn._rope_positions(pos, b, token.device)
    x = embed_tokens(cfg, params, token)
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"],
                                          cache["segments"]):
        for r in range(seg.repeats):
            layer, layer_cache = _index(seg_params, r), _index(seg_cache, r)
            for i, spec in enumerate(seg.pattern):
                x, _ = blocks.apply_layer_decode(
                    cfg, spec, layer[f"p{i}"], x, pos, positions,
                    layer_cache[f"p{i}"], swa_override=swa_override)
    return final_logits(cfg, params, x), cache
