"""Quantized KV page codecs (the counterpart of ``repro.pool.codec``).

A codec turns a full-precision KV page into a compact on-wire payload plus
a per-page scale, so every transfer below the configured tier boundary
(device→host puts, host→remote spills, and the fetches back) moves 2–4×
fewer bytes. Encoding happens once per put: ``pool.backend.CodecBackend``
wraps the storage backends of the tiers below the boundary, encodes on
``put`` and decodes on ``get``; a spill between two tiers of the same codec
moves the payload untouched.

Codecs:

- ``none`` — identity (no wrapping happens; pages move full precision);
- ``int8`` — symmetric per-page absmax quantization: ``scale =
  absmax/127`` (1.0 for an all-zero page; computed as the reference's
  compiled code computes it, see ``_absmax_scale``), payload
  ``round(x/scale)`` clamped to [-127, 127], computed in fp32.
  ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
  payload is the reference's bit for bit. The worst-case round-trip error
  is ``scale/2`` per element;
- ``fp8``  — ``torch.float8_e4m3fn`` payload with ``scale = absmax/448``
  (the format's max normal), so the page's absmax maps onto the format's
  range.

Encode and decode are plain PyTorch on the page's device, on the caller's
current stream. The scale stays a 0-dim fp32 tensor on that device: turning
it into a host float would cost a device→host sync per page. It still
counts 4 bytes in the on-wire size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

CODECS = ("none", "int8", "fp8")

#: float8_e4m3fn max normal — the target of the per-page scale
_FP8_MAX = 448.0


@dataclasses.dataclass
class EncodedPage:
    """One encoded page: the codec's handle.

    ``payload`` is whatever the wrapped tier's backend returned for the
    quantized tensor; ``scale`` is a 0-dim fp32 tensor on the device the
    page was encoded on; ``nbytes`` is the on-wire size (payload + 4 bytes
    of scale) that every pool and transfer counter charges."""

    codec: str
    payload: Any
    scale: torch.Tensor
    dtype: torch.dtype        # decoded dtype
    shape: Tuple[int, ...]
    nbytes: int


def _absmax_scale(x: torch.Tensor, top: float) -> torch.Tensor:
    """``absmax/top`` as the reference computes it: XLA turns a division by
    a constant into a product with the constant's fp32 reciprocal, so the
    scale is ``absmax * fp32(1/top)`` (the product of two fp32 numbers,
    rounded once, whatever precision the scalar is carried in)."""
    absmax = x.abs().amax()
    inv = float(np.float32(1.0 / top))
    return torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax))


class KVCodec:
    """One quantization scheme: tensor ↔ (1-byte payload, scale)."""

    name: str = "abstract"
    payload_itemsize: int = 1

    def encode(self, value: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def decode(self, payload: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
        return (payload.float() * scale).to(dtype)

    def ratio(self, itemsize: int) -> float:
        """On-wire bytes per decoded byte (< 1 compresses); the per-page
        scale is left out, the exact figure is ``encoded_nbytes``."""
        return self.payload_itemsize / float(itemsize)

    def encoded_nbytes(self, shape: Sequence[int], dtype: Any = None) -> int:
        """Exact on-wire size of one encoded page (payload + scale)."""
        n = 1
        for d in shape:
            n *= int(d)
        return n * self.payload_itemsize + 4

    def __repr__(self) -> str:
        return f"KVCodec({self.name})"


class Int8Codec(KVCodec):
    name = "int8"

    def encode(self, value):
        x = value.float()
        scale = _absmax_scale(x, 127.0)
        q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
        return q.to(torch.int8), scale


class Fp8Codec(KVCodec):
    name = "fp8"

    def encode(self, value):
        x = value.float()
        scale = _absmax_scale(x, _FP8_MAX)
        return (x / scale).to(torch.float8_e4m3fn), scale


def make_codec(name: Optional[str]) -> Optional[KVCodec]:
    """Codec instance by name; ``None``/``"none"`` → no codec (identity
    pages, no backend wrapping)."""
    if name is None or name == "none":
        return None
    if name == "int8":
        return Int8Codec()
    if name == "fp8":
        return Fp8Codec()
    raise ValueError(f"unknown KV codec {name!r}; have {CODECS}")


def roundtrip_bound(codec: KVCodec, absmax: float) -> float:
    """Hard per-element round-trip error bound for a page with the given
    absmax. int8: half a quantization step (absmax/254). fp8 (e4m3):
    relative error ≤ 2^-4 of the scaled element, so ``absmax * 2^-4``
    bounds any element."""
    if codec.name == "int8":
        return absmax / 254.0 + 1e-7
    if codec.name == "fp8":
        return absmax / 16.0 + 1e-7
    raise ValueError(f"no round-trip bound for codec {codec.name!r}")


def supports_fp8() -> bool:
    """This PyTorch build can make and convert ``float8_e4m3fn`` tensors."""
    try:
        torch.ones(1).to(torch.float8_e4m3fn).float()
        return True
    except (AttributeError, RuntimeError, TypeError):
        return False
