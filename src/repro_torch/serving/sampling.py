"""Token sampling: greedy / temperature / top-k.

Greedy is an argmax that picks the first maximum, as the reference's
``jnp.argmax`` does, so greedy tokens match the JAX package exactly.
Temperature and top-k draw from a ``torch.Generator``, which cannot
reproduce ``jax.random``'s bits.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling with temperature > 0 needs a generator")
    lg = logits.float() / temperature
    if top_k is not None:
        cutoff = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < cutoff, float("-inf"), lg)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
