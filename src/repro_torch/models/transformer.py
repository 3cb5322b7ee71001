"""Segment-stacked transformer: init, the encoder (whisper), forward,
prefill, chunked prefill and decode.

Parameters of each repeated layer pattern are stacked along a leading
``repeats`` dimension, exactly as the JAX reference lays them out
(``params["segments"][i]["p0"]["mixer"]["wq"]`` is (repeats, d, Hq·hd)), so
the reference's parameters load leaf by leaf. A Python loop over the repeats
dimension takes the place of ``lax.scan``; each layer sees views into the
stacked tensors, so KV caches (same stacked layout) are written in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import blocks, remat, runtime
from repro_torch.models.common import apply_norm, embed_init, norm_params, softcap
from repro_torch.sharding.ops import embed_lookup, linear
from repro_torch.sharding.rules import constrain


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
    if cfg.encoder is not None:
        n = cfg.encoder.n_layers
        params["encoder"] = {
            "layers": blocks.init_layer_params(cfg, ENCODER_LAYER, dtype,
                                               device, generator, (n,)),
            "final_norm": norm_params(cfg, device)}
    return params


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype, device: torch.device,
               swa_override: Optional[int] = None) -> Dict:
    """Stacked per-segment caches mirroring the parameter layout; a
    cross-attention layer's also holds the encoder's ``n_frames`` keys and
    values."""
    blocks.check_supported(cfg)
    enc_frames = cfg.encoder.n_frames if cfg.encoder is not None else None
    return {"segments": [
        {f"p{i}": blocks.init_layer_cache(cfg, spec, batch, max_seq, dtype,
                                          device, swa_override=swa_override,
                                          enc_frames=enc_frames,
                                          stack=(seg.repeats,))
         for i, spec in enumerate(seg.pattern)}
        for seg in cfg.segments]}


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position encodings, shape positions.shape + (d,). The
    frequencies' log(10000) is an fp32 tensor op, as in the reference: a
    Python double rounded once would move their last bits."""
    half = d // 2
    dev = positions.device
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                      device=dev))
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=dev)
                      * (log_base / max(half - 1, 1)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_tokens(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 vision_embeds: Optional[torch.Tensor] = None,
                 vision_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B,S,D); where ``vision_mask`` (B,S) is set, the
    frontend stub's aligned ``vision_embeds`` (B,S,D) take the token's
    place. Under ``rope_mode == "learned"`` the sinusoid of ``positions``
    (plane 0 of 3-plane positions) is added, as the reference does in
    place of whisper's learned table."""
    x = embed_lookup(params["embed"], tokens.long())
    if cfg.scale_embeddings:
        # the constant is rounded to x's type first, as the reference does;
        # filled on the device, not copied from the host, so a CUDA graph
        # can capture the step
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    if vision_embeds is not None and vision_mask is not None:
        x = torch.where(vision_mask[..., None], vision_embeds.to(x.dtype), x)
    if cfg.rope_mode == "learned":
        pos2d = positions if positions.dim() == 2 else positions[0]
        x = x + _sinusoid(pos2d, cfg.d_model).to(x.dtype)
    return constrain(x, ("batch", "seq_act", "embed_act"))


def final_logits(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = linear(x, params["embed"].T)
    else:
        logits = linear(x, params["lm_head"])
    logits = softcap(logits.float(), cfg.final_logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        # padded vocab: pad columns never win softmax/argmax
        pad = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(pad, logits, -1e30)
    return constrain(logits, ("batch", "seq", "vocab"))


def _default_positions(cfg: ModelConfig, tokens: torch.Tensor,
                       offset: int = 0) -> torch.Tensor:
    """Positions offset, offset+1, ... of every row: (B,S), or (3,B,S)
    with equal planes under M-RoPE."""
    b, s = tokens.shape
    pos = offset + torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    return _planes(cfg, pos)


def _planes(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """(B,S) positions as M-RoPE's three equal planes where the config
    asks for them, as the reference continues text positions."""
    if cfg.rope_mode == "mrope":
        return positions[None].expand(3, *positions.shape)
    return positions


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------

#: every encoder layer: bidirectional self-attention and a GELU MLP
ENCODER_LAYER = LayerSpec(mixer="attn", ffn="gelu")


def encode(cfg: ModelConfig, params: Dict,
           enc_embeds: torch.Tensor) -> torch.Tensor:
    """enc_embeds (B, frames, D), the frontend stub's precomputed
    embeddings → the encoder output (B, frames, D), in the embeddings'
    type promoted with the weights', as in the reference: fp32 embeddings
    run the encoder in fp32 over bf16 weights (``sharding.ops.linear``
    promotes at each product, as ``jnp``'s ``@`` does), and so the cross
    keys and values made from its output. Each layer
    attends without a causal mask, and is always rematerialised in the
    backward (the reference's ``jax.checkpoint`` around its scan body):
    otherwise every layer's (frames × frames) scores would be kept."""
    from torch.utils.checkpoint import checkpoint
    enc = params["encoder"]
    b, t, _ = enc_embeds.shape
    pos = torch.arange(t, device=enc_embeds.device)[None, :].expand(b, t)
    x = enc_embeds + _sinusoid(pos, cfg.d_model).to(enc_embeds.dtype)
    for r in range(cfg.encoder.n_layers):
        layer = functools.partial(blocks.apply_layer, cfg, ENCODER_LAYER,
                                  _index(enc["layers"], r), positions=pos,
                                  causal=False)
        if torch.is_grad_enabled():
            x, _ = checkpoint(runtime.under_forward_context(layer), x,
                              use_reentrant=False)
        else:
            x, _ = layer(x)
    return apply_norm(cfg, enc["final_norm"], x)


def _enc_out(cfg: ModelConfig, params: Dict,
             enc_embeds: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if cfg.encoder is None:
        return None
    if enc_embeds is None:
        raise ValueError(f"{cfg.name} needs the encoder frontend's "
                         f"embeddings (batch['enc_embeds'])")
    return encode(cfg, params, enc_embeds)


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            vision_mask: Optional[torch.Tensor] = None,
            swa_override: Optional[int] = None,
            remat_policy=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits, aux_loss).

    With a ``remat_policy`` (``repro_torch.offload.policies``) each repeat
    of a segment's layer pattern runs through the policy, as the reference
    wraps each repeat in ``jax.checkpoint(pattern_body, policy=...)``. A
    stacked leaf may also come as a list of per-layer tensors (the train
    step's gradient leaves). The encoder output (whisper) reaches every
    layer as an argument of its own, so a policy's stages differentiate
    it."""
    if positions is None:
        positions = _default_positions(cfg, tokens)
    enc_out = _enc_out(cfg, params, enc_embeds)
    x = embed_tokens(cfg, params, tokens, positions, vision_embeds,
                     vision_mask)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    run = remat_policy.bind() if remat_policy is not None else None
    for seg, seg_params in zip(cfg.segments, params["segments"]):
        for r in range(seg.repeats):
            layer = _index(seg_params, r)
            layers = [functools.partial(
                blocks.apply_layer, cfg, spec, layer[f"p{i}"],
                positions=positions, enc_out=enc_out,
                swa_override=swa_override)
                for i, spec in enumerate(seg.pattern)]
            x, a = remat.run_layers(layers, x) if run is None \
                else run(layers, x)
            aux = aux + a
    return final_logits(cfg, params, x), aux


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            cache: Dict, *, positions: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            vision_mask: Optional[torch.Tensor] = None,
            swa_override: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Forward over the prompt; fills ``cache`` in place (with whisper's
    encoded frames in its cross-attention leaves). Returns (last-token
    logits (B,1,V), cache)."""
    if positions is None:
        positions = _default_positions(cfg, tokens)
    enc_out = _enc_out(cfg, params, enc_embeds)
    x = embed_tokens(cfg, params, tokens, positions, vision_embeds,
                     vision_mask)
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"],
                                          cache["segments"]):
        for r in range(seg.repeats):
            layer, layer_cache = _index(seg_params, r), _index(seg_cache, r)
            for i, spec in enumerate(seg.pattern):
                x, _, _ = blocks.apply_layer_prefill(
                    cfg, spec, layer[f"p{i}"], x, positions,
                    layer_cache[f"p{i}"], enc_out=enc_out,
                    swa_override=swa_override)
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
    positions = _default_positions(cfg, tokens, offset)
    x = embed_tokens(cfg, params, tokens, positions)
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
    positions = _planes(cfg, attn._rope_positions(pos, b, token.device))
    x = embed_tokens(cfg, params, token, positions)
    for seg, seg_params, seg_cache in zip(cfg.segments, params["segments"],
                                          cache["segments"]):
        for r in range(seg.repeats):
            layer, layer_cache = _index(seg_params, r), _index(seg_cache, r)
            for i, spec in enumerate(seg.pattern):
                x, _ = blocks.apply_layer_decode(
                    cfg, spec, layer[f"p{i}"], x, pos, positions,
                    layer_cache[f"p{i}"], swa_override=swa_override)
    return final_logits(cfg, params, x), cache
