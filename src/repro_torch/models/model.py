"""Public model facade: build once from a ``ModelConfig``, then call
``init`` / ``forward`` / ``prefill`` / ``prefill_chunk`` / ``decode_step``,
or ask ``cache_specs`` for a cache's shapes and types."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm


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

    def forward(self, params: Dict, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        return tfm.forward(self.cfg, params, batch["tokens"],
                           positions=batch.get("positions"),
                           swa_override=self.swa_override)

    def prefill(self, params: Dict, batch: Dict,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
        return tfm.prefill(self.cfg, params, batch["tokens"], cache,
                           positions=batch.get("positions"),
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

    def cache_specs(self, batch: int, max_seq: int,
                    dtype: torch.dtype = torch.bfloat16) -> Dict:
        """The cache ``init_cache`` would build, as tensors on the ``meta``
        device: shapes and types, no memory."""
        return tfm.init_cache(self.cfg, batch, max_seq, dtype,
                              torch.device("meta"),
                              swa_override=self.swa_override)

    def decode_step(self, params: Dict, cache: Dict, token: torch.Tensor,
                    pos) -> Tuple[torch.Tensor, Dict]:
        return tfm.decode_step(self.cfg, params, cache, token, pos,
                               swa_override=self.swa_override)


def build_model(cfg: ModelConfig, shape: Optional[InputShape] = None) -> Model:
    """Build a Model; enables the documented sliding-window variant when the
    workload is long_500k and the arch is full-attention."""
    swa = None
    if shape is not None and shape.name == "long_500k" \
            and cfg.long_context == "swa-variant":
        swa = cfg.swa_variant_window
    return Model(cfg=cfg, swa_override=swa)
