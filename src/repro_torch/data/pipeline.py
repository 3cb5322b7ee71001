"""Deterministic synthetic token pipeline (the counterpart of
``repro.data.pipeline``).

Every batch is drawn from a CPU ``torch.Generator`` seeded by ``(seed,
step)``, so any step's batch can be made again on its own. Learnable
structure, as in the reference: the next token is the previous one
through a fixed random permutation (drawn from ``seed + 1``), replaced by
a uniform token with probability ``noise``; ``targets`` are the tokens
shifted by one. The structure is the reference's; the draws are torch's,
so the tokens are not JAX's. Given a config with a frontend stub, a batch
also carries the stub's inputs, drawn from a generator of their own (the
tokens stay those of the same step without them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike


def _generator(*key: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(key)).generate_state(1,
                                                               np.uint64)[0])
    return torch.Generator().manual_seed(seed)


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1           # fraction of uniformly random tokens

    def batch(self, step: int, cfg: Optional[ModelConfig] = None,
              device: DeviceLike = "cpu") -> Dict[str, torch.Tensor]:
        """The full global batch for ``step``: int32 ``tokens`` and
        ``targets`` (B, S), and with ``cfg`` its frontend stub's inputs
        (:meth:`_frontend`), made on the CPU and moved to ``device``."""
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        perm = torch.randperm(v, generator=_generator(self.seed + 1))
        gen = _generator(self.seed, step)
        tok = torch.randint(0, v, (b,), generator=gen)
        first = tok
        u = torch.rand((s, b), generator=gen)
        rnd = torch.randint(0, v, (s, b), generator=gen)
        seq = torch.empty((s, b), dtype=torch.int64)
        for i in range(s):
            tok = torch.where(u[i] < self.noise, rnd[i], perm[tok])
            seq[i] = tok
        seq = seq.T
        tokens = torch.cat([first[:, None], seq[:, :-1]], dim=1)
        out = {"tokens": tokens.to(torch.int32),
               "targets": seq.to(torch.int32)}
        if cfg is not None:
            out.update(self._frontend(cfg, _generator(self.seed, step, 1)))
        return {k: t.to(device) for k, t in out.items()}

    def _frontend(self, cfg: ModelConfig,
                  gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """Frontend-stub inputs, fp32 as the reference makes them: audio,
        ``enc_embeds`` (B, n_frames, D) of 0.1 x N(0, 1); vision, the first
        max(1, S//8) positions of every row flagged in ``vision_mask`` and
        given 0.1 x N(0, 1) ``vision_embeds`` (zero elsewhere), with
        ``positions`` the sequence index in all three M-RoPE planes."""
        b, s = self.global_batch, self.seq_len
        if cfg.frontend == "audio":
            return {"enc_embeds": 0.1 * torch.randn(
                (b, cfg.encoder.n_frames, cfg.d_model), generator=gen)}
        if cfg.frontend == "vision":
            n_vis = max(1, s // 8)
            mask = torch.zeros((b, s), dtype=torch.bool)
            mask[:, :n_vis] = True
            emb = torch.zeros((b, s, cfg.d_model))
            emb[:, :n_vis] = 0.1 * torch.randn((b, n_vis, cfg.d_model),
                                               generator=gen)
            pos = torch.arange(s, dtype=torch.int32).expand(3, b, s)
            return {"vision_embeds": emb, "vision_mask": mask,
                    "positions": pos.contiguous()}
        return {}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """``meta`` tensors matching ``SyntheticTokens.batch`` (the dry-run's
    inputs): int32 tokens and targets, the frontend stub's inputs in
    ``dtype``, the vision mask bool and M-RoPE positions int32."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    out = {"tokens": meta((global_batch, seq_len), torch.int32),
           "targets": meta((global_batch, seq_len), torch.int32)}
    if cfg.frontend == "audio":
        out["enc_embeds"] = meta((global_batch, cfg.encoder.n_frames,
                                  cfg.d_model), dtype)
    elif cfg.frontend == "vision":
        out["vision_embeds"] = meta((global_batch, seq_len, cfg.d_model),
                                    dtype)
        out["vision_mask"] = meta((global_batch, seq_len), torch.bool)
        out["positions"] = meta((3, global_batch, seq_len), torch.int32)
    return out
