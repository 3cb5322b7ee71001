"""Public model facade: build once from a ``ModelConfig``, then call
``init`` / ``loss`` / ``forward`` / ``prefill`` / ``prefill_chunk`` /
``decode_step``, or ask ``param_specs`` / ``cache_specs`` / ``input_specs``
for the shapes and types of parameters, a cache or a workload's batch
(``meta`` tensors: the dry-run's stand-ins, which allocate nothing).

Modality frontends are stubs, as in the reference: an audio model's batch
carries ``enc_embeds`` (precomputed conv/mel frames, (B, n_frames, D)); a
vision model's carries aligned ``vision_embeds`` (B,S,D) with their
``vision_mask`` (B,S) and M-RoPE ``positions`` (3,B,S)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm


#: a batch's model inputs beside its tokens (the frontend stubs' and the
#: M-RoPE positions)
FRONTEND_KEYS = ("positions", "enc_embeds", "vision_embeds", "vision_mask")


def _frontend(batch: Dict) -> Dict:
    return {k: batch.get(k) for k in FRONTEND_KEYS}


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in fp32. logits (B,S,V), targets (B,S) int."""
    logz = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logz, -1, targets.long()[..., None])[..., 0]
    return -torch.mean(ll)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    swa_override: Optional[int] = None

    def init(self, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> Dict:
        """Random parameters drawn from ``generator`` (a generator on
        ``device``; seed 0 when omitted) on ``device`` (default CUDA)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return tfm.init_params(self.cfg, generator, dtype, dev)

    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> Dict:
        return tfm.init_cache(self.cfg, batch, max_seq, dtype,
                              resolve_device(device),
                              swa_override=self.swa_override)

    # -- training -----------------------------------------------------------
    def forward(self, params: Dict, batch: Dict, remat_policy=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return tfm.forward(self.cfg, params, batch["tokens"],
                           **_frontend(batch),
                           swa_override=self.swa_override,
                           remat_policy=remat_policy)

    def loss(self, params: Dict, batch: Dict,
             remat_policy=None) -> torch.Tensor:
        logits, aux = self.forward(params, batch, remat_policy=remat_policy)
        return _xent(logits, batch["targets"]) + aux

    # -- inference ----------------------------------------------------------

    def prefill(self, params: Dict, batch: Dict,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
        return tfm.prefill(self.cfg, params, batch["tokens"], cache,
                           **_frontend(batch),
                           swa_override=self.swa_override)

    def prefill_chunk(self, params: Dict, batch: Dict, offset: int,
                      valid_len: int, cache: Dict) -> Tuple[torch.Tensor, Dict]:
        """Cache-aware prefill of one prompt chunk at global position
        ``offset`` (see ``transformer.prefill_chunk``); only the first
        ``valid_len`` tokens are real, and the logits are the last valid
        token's. Needs ``supports_chunked_prefill``."""
        return tfm.prefill_chunk(self.cfg, params, batch["tokens"], offset,
                                 valid_len, cache,
                                 swa_override=self.swa_override)

    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill resumes from a per-position KV cache; recurrent
        (mamba2) mixers, cross-attention layers and encoder frontends carry
        state the chunk path cannot."""
        return self.cfg.encoder is None and all(
            spec.mixer in ("attn", "mla") and not spec.cross_attn
            for seg in self.cfg.segments for spec in seg.pattern)

    # -- dry-run specs --------------------------------------------------------
    def param_specs(self, dtype: torch.dtype = torch.bfloat16) -> Dict:
        """The parameters ``init`` would build, as tensors on the ``meta``
        device: shapes and types, no memory (mixtral-8x22b's 282 GB
        included)."""
        return tfm.init_params(self.cfg, None, dtype, torch.device("meta"))

    def cache_specs(self, batch: int, max_seq: int,
                    dtype: torch.dtype = torch.bfloat16) -> Dict:
        """The cache ``init_cache`` would build, as tensors on the ``meta``
        device: shapes and types, no memory."""
        return tfm.init_cache(self.cfg, batch, max_seq, dtype,
                              torch.device("meta"),
                              swa_override=self.swa_override)

    def input_specs(self, shape: InputShape,
                    dtype: torch.dtype = torch.bfloat16) -> Dict:
        """``meta`` stand-ins for a workload's batch: train, tokens and
        targets (B,S) with the frontend stub's inputs; prefill, tokens with
        them; decode, one token (B,1) and a 0-dim ``pos``. Integers are
        int32, as in the reference."""
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            batch = {"tokens": _meta((b, s), torch.int32),
                     "targets": _meta((b, s), torch.int32)}
            self._add_frontend_specs(batch, b, s, dtype)
            return batch
        if shape.kind == "prefill":
            batch = {"tokens": _meta((b, s), torch.int32)}
            self._add_frontend_specs(batch, b, s, dtype)
            return batch
        if shape.kind == "decode":
            return {"token": _meta((b, 1), torch.int32),
                    "pos": _meta((), torch.int32)}
        raise ValueError(shape.kind)

    def _add_frontend_specs(self, batch: Dict, b: int, s: int,
                            dtype: torch.dtype) -> None:
        cfg = self.cfg
        if cfg.frontend == "audio":
            batch["enc_embeds"] = _meta((b, cfg.encoder.n_frames,
                                         cfg.d_model), dtype)
        elif cfg.frontend == "vision":
            batch["vision_embeds"] = _meta((b, s, cfg.d_model), dtype)
            batch["vision_mask"] = _meta((b, s), torch.bool)
            batch["positions"] = _meta((3, b, s), torch.int32)

    def decode_step(self, params: Dict, cache: Dict, token: torch.Tensor,
                    pos) -> Tuple[torch.Tensor, Dict]:
        return tfm.decode_step(self.cfg, params, cache, token, pos,
                               swa_override=self.swa_override)


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_model(cfg: ModelConfig, shape: Optional[InputShape] = None) -> Model:
    """Build a Model; enables the documented sliding-window variant when the
    workload is long_500k and the arch is full-attention."""
    swa = None
    if shape is not None and shape.name == "long_500k" \
            and cfg.long_context == "swa-variant":
        swa = cfg.swa_variant_window
    return Model(cfg=cfg, swa_override=swa)


# re-exported as in the reference
init_params = tfm.init_params
init_cache = tfm.init_cache
