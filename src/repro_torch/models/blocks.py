"""Layer (block) application: pre-norm residual structure over a mixer
(GQA attention or Mamba2) and an FFN, with gemma2-style optional
post-sublayer norms. One code path per execution mode (forward, prefill,
decode) so caches stay explicit."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_norm, norm_params


def check_supported(cfg: ModelConfig) -> None:
    """The port runs decoders whose layers are GQA attention with a SwiGLU
    or GELU FFN (or none), or Mamba2 with no FFN (mamba2, the zamba2
    hybrid); MoE, MLA, cross-attention, encoders and vision frontends come
    in later slices."""
    bad = []
    if cfg.encoder is not None or cfg.frontend != "none":
        bad.append("encoder/frontend")
    if cfg.rope_mode not in ("rope", "none"):
        bad.append(f"rope_mode={cfg.rope_mode}")
    for seg in cfg.segments:
        for spec in seg.pattern:
            if spec.mixer == "mamba2":
                if spec.ffn != "none":
                    bad.append(f"mixer=mamba2 ffn={spec.ffn}")
                continue
            if spec.mixer != "attn" or spec.cross_attn:
                bad.append(f"mixer={spec.mixer} cross_attn={spec.cross_attn}")
            if spec.ffn not in ("swiglu", "gelu", "none"):
                bad.append(f"ffn={spec.ffn}")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: not in the PyTorch port yet: {sorted(set(bad))}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_layer_params(cfg: ModelConfig, spec: LayerSpec, dtype: torch.dtype,
                      device: torch.device, generator: torch.Generator,
                      stack: Sequence[int] = ()) -> Dict:
    if spec.mixer == "mamba2":
        mixer = ssm_mod.init_mamba_params(cfg, dtype, device, generator, stack)
    else:
        mixer = attn.init_attn_params(cfg, spec, dtype, device, generator,
                                      stack)
    p: Dict = {"pre_norm": norm_params(cfg, device, stack), "mixer": mixer}
    if spec.post_norms:
        p["post_norm"] = norm_params(cfg, device, stack)
    if spec.ffn != "none":
        p["ffn_norm"] = norm_params(cfg, device, stack)
        if spec.ffn == "gelu":
            p["ffn"] = mlp_mod.init_gelu_params(cfg, dtype, device, generator,
                                                stack)
        else:
            p["ffn"] = mlp_mod.init_swiglu_params(cfg, dtype, device,
                                                  generator, stack)
        if spec.post_norms:
            p["post_ffn_norm"] = norm_params(cfg, device, stack)
    return p


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_seq: int, dtype: torch.dtype, device: torch.device,
                     swa_override: Optional[int] = None,
                     stack: Sequence[int] = ()) -> Dict:
    if spec.mixer == "mamba2":
        return ssm_mod.init_mamba_cache(cfg, batch, dtype, device, stack)
    return attn.init_attn_cache(cfg, spec, batch, max_seq, dtype, device,
                                swa_override=swa_override, stack=stack)


# ---------------------------------------------------------------------------
# Sublayers
# ---------------------------------------------------------------------------


def _ffn(cfg: ModelConfig, spec: LayerSpec, p: Dict,
         x: torch.Tensor) -> torch.Tensor:
    if spec.ffn == "none":
        return x
    h = apply_norm(cfg, p["ffn_norm"], x)
    h = mlp_mod.gelu_mlp(p["ffn"], h) if spec.ffn == "gelu" \
        else mlp_mod.swiglu(p["ffn"], h)
    if spec.post_norms:
        h = apply_norm(cfg, p["post_ffn_norm"], h)
    return x + h


def _post_mixer(cfg: ModelConfig, spec: LayerSpec, p: Dict, x: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
    if spec.post_norms:
        h = apply_norm(cfg, p["post_norm"], h)
    return _ffn(cfg, spec, p, x + h)


def apply_layer(cfg: ModelConfig, spec: LayerSpec, p: Dict, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True,
                swa_override: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward without a cache. Returns (x, aux_loss)."""
    h = apply_norm(cfg, p["pre_norm"], x)
    if spec.mixer == "mamba2":
        h = ssm_mod.mamba_forward(cfg, p["mixer"], h)
    else:
        h = attn.attention_full(cfg, spec, p["mixer"], h, positions,
                                causal=causal, swa_override=swa_override)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _post_mixer(cfg, spec, p, x, h), aux


def apply_layer_prefill(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                        x: torch.Tensor, positions: torch.Tensor,
                        cache: Dict, *, swa_override: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Forward over the prompt, filling ``cache`` in place.
    Returns (x, aux_loss, cache)."""
    h = apply_norm(cfg, p["pre_norm"], x)
    if spec.mixer == "mamba2":
        h, cache = ssm_mod.mamba_prefill(cfg, p["mixer"], h, cache)
    else:
        h, cache = attn.attention_prefill(cfg, spec, p["mixer"], h, positions,
                                          cache, swa_override=swa_override)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _post_mixer(cfg, spec, p, x, h), aux, cache


def apply_layer_prefill_chunk(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                              x: torch.Tensor, offset: int,
                              positions: torch.Tensor, valid_len: int,
                              cache: Dict, *, swa_override: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """One prefill chunk through one layer: the chunk attends over
    ``[cache ++ chunk]`` at its offset and the cache advances (in place) by
    the chunk's valid K/V. Attention layers only — a Mamba2 or
    cross-attention layer has no per-position cache to resume from
    (``Model.supports_chunked_prefill`` gates this upstream). Returns (x,
    aux_loss, cache)."""
    if spec.mixer == "mamba2" or spec.cross_attn:
        raise NotImplementedError(
            "chunked prefill supports attention self-attention layers only "
            "(gate on Model.supports_chunked_prefill)")
    h = apply_norm(cfg, p["pre_norm"], x)
    h, cache = attn.attention_prefill_chunk(
        cfg, spec, p["mixer"], h, offset, positions, valid_len, cache,
        swa_override=swa_override)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _post_mixer(cfg, spec, p, x, h), aux, cache


def apply_layer_decode(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                       x: torch.Tensor, pos, positions: torch.Tensor,
                       cache: Dict, *, swa_override: Optional[int] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """One token (B,1,D); the cache is updated in place."""
    h = apply_norm(cfg, p["pre_norm"], x)
    if spec.mixer == "mamba2":
        h, cache = ssm_mod.mamba_decode(cfg, p["mixer"], h, cache)
    else:
        h, cache = attn.attention_decode(cfg, spec, p["mixer"], h, pos,
                                         positions, cache,
                                         swa_override=swa_override)
    return _post_mixer(cfg, spec, p, x, h), cache
