"""Deterministic synthetic token pipeline (the counterpart of
``repro.data.pipeline``).

Every batch is drawn from a CPU ``torch.Generator`` seeded by ``(seed,
step)``, so any step's batch can be made again on its own. Learnable
structure, as in the reference: the next token is the previous one
through a fixed random permutation (drawn from ``seed + 1``), replaced by
a uniform token with probability ``noise``; ``targets`` are the tokens
shifted by one. The structure is the reference's; the draws are torch's,
so the tokens are not JAX's.
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
        ``targets`` (B, S), made on the CPU and moved to ``device``. The
        port's models take no frontend inputs, so ``cfg`` (the reference's
        hook for audio/vision stubs) must have none."""
        if cfg is not None and cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: frontend {cfg.frontend!r} is not in the port")
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
        return {"tokens": tokens.to(torch.int32).to(device),
                "targets": seq.to(torch.int32).to(device)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
