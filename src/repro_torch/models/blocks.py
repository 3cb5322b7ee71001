"""Layer (block) application: pre-norm residual structure over a mixer
(GQA attention, MLA or Mamba2) and an FFN (SwiGLU, GELU or MoE, whose aux
loss the forward and prefill paths return), with gemma2-style optional
post-sublayer norms and whisper-style cross-attention sublayers between the
mixer and the FFN. One code path per execution mode (forward, prefill,
decode) so caches stay explicit."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import remat
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_norm, norm_params
from repro_torch.sharding.rules import constrain


def check_supported(cfg: ModelConfig) -> None:
    """The port runs the reference's layer kinds: GQA or MLA attention
    (with or without cross-attention to an encoder) with a SwiGLU, GELU or
    MoE FFN (or none), and Mamba2 with no FFN (mamba2, the zamba2 hybrid),
    under RoPE, M-RoPE, learned (sinusoidal) or no position encoding."""
    bad = []
    if cfg.rope_mode not in ("rope", "mrope", "learned", "none"):
        bad.append(f"rope_mode={cfg.rope_mode}")
    for seg in cfg.segments:
        for spec in seg.pattern:
            if spec.mixer == "mamba2":
                if spec.ffn != "none":
                    bad.append(f"mixer=mamba2 ffn={spec.ffn}")
                continue
            if spec.mixer not in ("attn", "mla"):
                bad.append(f"mixer={spec.mixer}")
            if spec.ffn not in ("swiglu", "gelu", "moe", "none"):
                bad.append(f"ffn={spec.ffn}")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: not in the PyTorch port: {sorted(set(bad))}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_layer_params(cfg: ModelConfig, spec: LayerSpec, dtype: torch.dtype,
                      device: torch.device, generator: torch.Generator,
                      stack: Sequence[int] = ()) -> Dict:
    if spec.mixer == "mamba2":
        mixer = ssm_mod.init_mamba_params(cfg, dtype, device, generator, stack)
    elif spec.mixer == "mla":
        mixer = attn.init_mla_params(cfg, dtype, device, generator, stack)
    else:
        mixer = attn.init_attn_params(cfg, spec, dtype, device, generator,
                                      stack)
    p: Dict = {"pre_norm": norm_params(cfg, device, stack), "mixer": mixer}
    if spec.post_norms:
        p["post_norm"] = norm_params(cfg, device, stack)
    if spec.cross_attn:
        p["cross_norm"] = norm_params(cfg, device, stack)
    if spec.ffn != "none":
        p["ffn_norm"] = norm_params(cfg, device, stack)
        if spec.ffn == "moe":
            p["ffn"] = moe_mod.init_moe_params(cfg, dtype, device, generator,
                                               stack)
        elif spec.ffn == "gelu":
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
                     enc_frames: Optional[int] = None,
                     stack: Sequence[int] = ()) -> Dict:
    if spec.mixer == "mamba2":
        return ssm_mod.init_mamba_cache(cfg, batch, dtype, device, stack)
    return attn.init_attn_cache(cfg, spec, batch, max_seq, dtype, device,
                                swa_override=swa_override,
                                enc_frames=enc_frames, stack=stack)


# ---------------------------------------------------------------------------
# Sublayers
# ---------------------------------------------------------------------------


def _constrain_resid(x: torch.Tensor) -> torch.Tensor:
    """The sharding of the residual stream and of the sublayer outputs
    added to it (sequence-split under the launcher's ``seq_act`` rule)."""
    return constrain(x, ("batch", "seq_act", "embed_act"))


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn_out(cfg: ModelConfig, spec: LayerSpec, p: Dict, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN sublayer's output (after its post-norm), before the
    residual add, and its aux loss (an MoE FFN's; zero for a dense one)."""
    h = apply_norm(cfg, p["ffn_norm"], x)
    if spec.ffn == "moe":
        h, aux = moe_mod.moe_ffn(cfg, p["ffn"], h)
    else:
        aux = _zero_aux(x)
        h = mlp_mod.gelu_mlp(p["ffn"], h) if spec.ffn == "gelu" \
            else mlp_mod.swiglu(p["ffn"], h)
    if spec.post_norms:
        h = apply_norm(cfg, p["post_ffn_norm"], h)
    return h, aux


def _cross(cfg: ModelConfig, p: Dict, x: torch.Tensor, kv) -> torch.Tensor:
    """The residual stream after the cross-attention sublayer: ``kv`` is
    the encoder output (B,T,D), or a decode step's cache with ``xk``/
    ``xv``."""
    h = apply_norm(cfg, p["cross_norm"], x)
    if isinstance(kv, dict):
        return x + attn.cross_attention_decode(cfg, p["mixer"], h, kv)
    return x + attn.cross_attention_full(cfg, p["mixer"], h, kv)


def _post_mixer(cfg: ModelConfig, spec: LayerSpec, p: Dict, x: torch.Tensor,
                h: torch.Tensor, cross=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rest of a layer after its mixer's output ``h``: the mixer's
    post-norm, the residual add, the cross-attention sublayer (over
    ``cross``, the encoder output or the decode cache, when the layer has
    one) and the FFN. Returns (x, aux_loss)."""
    if spec.post_norms:
        h = apply_norm(cfg, p["post_norm"], h)
    x = x + h
    if spec.cross_attn and cross is not None:
        x = _cross(cfg, p, x, cross)
    if spec.ffn == "none":
        return x, _zero_aux(x)
    h, aux = _ffn_out(cfg, spec, p, x)
    return x + h, aux


def apply_layer(cfg: ModelConfig, spec: LayerSpec, p: Dict, x: torch.Tensor,
                positions: torch.Tensor, *,
                enc_out: Optional[torch.Tensor] = None, causal: bool = True,
                swa_override: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward without a cache. Returns (x, aux_loss). The mixer's output,
    the FFN's and the layer's are the tag points ``attn_out``, ``mlp_out``
    and ``resid`` (``models.remat``), as in the reference. A
    cross-attention layer attends over ``enc_out`` between the two; the
    cross sublayer runs with the FFN (the values between ``attn_out`` and
    ``mlp_out``, which the reference recomputes), and takes ``enc_out`` as
    an input of its own, never closed over, so an offloaded stage carries
    its gradient."""

    def mixer(p: Dict, x: torch.Tensor) -> torch.Tensor:
        h = apply_norm(cfg, p["pre_norm"], x)
        if spec.mixer == "mamba2":
            h = ssm_mod.mamba_forward(cfg, p["mixer"], h)
        else:
            h = attn.attention_full(cfg, spec, p["mixer"], h, positions,
                                    causal=causal, swa_override=swa_override)
        if spec.post_norms:
            h = apply_norm(cfg, p["post_norm"], h)
        return _constrain_resid(h)

    def ffn(p: Dict, x: torch.Tensor, h: torch.Tensor, *enc: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = x + h
        if enc:
            x = _cross(cfg, p, x, enc[0])
        h, aux = _ffn_out(cfg, spec, p, x)
        return _constrain_resid(h), x, aux

    cross = (enc_out,) if spec.cross_attn and enc_out is not None else ()
    h = remat.sublayer("attn_out", mixer, p, x)
    if spec.ffn != "none":
        h, x, aux = remat.sublayer("mlp_out", ffn, p, x, h, *cross)
        return remat.tag(_constrain_resid(x + h), "resid"), aux
    x = x + h
    if cross:
        x = _cross(cfg, p, x, enc_out)
    return remat.tag(_constrain_resid(x), "resid"), _zero_aux(x)


def apply_layer_prefill(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                        x: torch.Tensor, positions: torch.Tensor,
                        cache: Dict, *,
                        enc_out: Optional[torch.Tensor] = None,
                        swa_override: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Forward over the prompt, filling ``cache`` in place (a
    cross-attention layer's ``xk``/``xv`` from ``enc_out`` too).
    Returns (x, aux_loss, cache)."""
    h = apply_norm(cfg, p["pre_norm"], x)
    if spec.mixer == "mamba2":
        h, cache = ssm_mod.mamba_prefill(cfg, p["mixer"], h, cache)
    else:
        h, cache = attn.attention_prefill(cfg, spec, p["mixer"], h, positions,
                                          cache, swa_override=swa_override,
                                          enc_out=enc_out)
    x, aux = _post_mixer(cfg, spec, p, x, h, enc_out)
    return _constrain_resid(x), aux, cache


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
    x, aux = _post_mixer(cfg, spec, p, x, h)
    return _constrain_resid(x), aux, cache


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
    # decode drops the aux loss; cross-attention reads the cached frames
    x, _ = _post_mixer(cfg, spec, p, x, h, cache)
    return x, cache
