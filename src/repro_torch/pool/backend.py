"""Tiered memory backends behind one interface.

Backends are selected per tier by a declarative ``TierSpec.kind``
(``pool.topology``); the default chain is the paper's hierarchy:

- **device** — the pool's device memory (CUDA tensors on the card, CPU
  tensors when the pool runs on the CPU);
- **host**   — pinned CPU tensors when the pool's device is CUDA, so
  host↔device copies run asynchronously on the transfer stream. Pinning
  that fails raises: there is no quiet fallback to pageable memory on the
  card. When the pool runs on the CPU, the host tier is plain CPU memory;
- **numpy**  — plain (pageable) CPU tensors;
- **modeled** — plain CPU tensors behind a sleep-throttle that *enforces*
  the spec's per-direction bandwidth and latency. Unthrottled it is a plain
  CPU tier.

``CodecBackend`` wraps any of these below a tier boundary with a KV page
codec (``pool.codec``): pages are encoded on ``put`` and decoded on
``get``.

Every backend stores a snapshot: ``put`` copies, and ``get`` hands back a
new tensor on the pool's device that the caller owns (callers update their
tensors in place, so neither side may alias the stored copy). A backend
that is handed the entry's previous handle (``reuse``) copies into it when
shape and type match, so re-putting one key every step allocates — and, on
the host tier, pins — its buffer once.

A fetch that is one plain copy of the stored tensor (the device and host
tiers) names that tensor (``source``), so the pool can copy it straight
into a destination the caller owns; a tier that decodes or throttles
(``CodecBackend``, ``CpuTensorBackend``) names none and is read with
``get``.

A caller that wants a put's or get's copies timed (telemetry on) hands
it a list (``timings``): on a CUDA device the host tier then queues its
copies through the transfer engine's ``copy``, which times each on the
device and appends its timing there (a fetch job times the copies of the
tensors ``source`` names itself). Without a list they copy as they always
did.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.pool import codec as codec_mod

DEVICE_TIER = "device"
HOST_TIER = "host"
REMOTE_TIER = "remote"

#: gives the transfer engine's copy stream for a CUDA device
StreamFor = Callable[[torch.device], "torch.cuda.Stream"]
#: queues ``dst <- src`` on the current stream, timed on the device, and
#: appends its timing to the list (the transfer engine's ``copy``)
TimedCopy = Callable[[torch.Tensor, torch.Tensor, list], None]


def tensor_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: host memory kinds a caller may name (the reference's spellings); None
#: lets the device decide
HOST_KINDS = (None, "pinned_host", "unpinned_host")


def pinned_host(device: torch.device, kind: Optional[str] = None) -> bool:
    """Whether host copies of ``device`` tensors are pinned: always on
    CUDA, where pageable memory would make every copy synchronous (so
    ``"unpinned_host"`` is refused there), never on the CPU."""
    if kind not in HOST_KINDS:
        raise ValueError(f"unknown host memory kind {kind!r}; "
                         f"have {HOST_KINDS}")
    if device.type != "cuda":
        return False
    if kind == "unpinned_host":
        raise ValueError("host memory on CUDA is pinned; 'unpinned_host' "
                         "is not offered")
    return True


def is_host_resident(x: Any, device: Optional[torch.device] = None) -> bool:
    """True if ``x`` lives in the host tier of a pool on ``device``
    (default CUDA): a CPU tensor, and a pinned one when the device is
    CUDA."""
    dev = torch.device("cuda" if device is None else device)
    return (isinstance(x, torch.Tensor) and x.device.type == "cpu"
            and (dev.type != "cuda" or x.is_pinned()))


def _reusable(buf: Optional[torch.Tensor], value: torch.Tensor,
              device: torch.device) -> bool:
    return (isinstance(buf, torch.Tensor) and buf.shape == value.shape
            and buf.dtype == value.dtype and buf.device == device)


class MemoryBackend:
    """One storage tier: ``put`` stores a tensor into the tier and returns
    a handle; ``get`` materializes a handle on the pool's device. Where a
    tier can time its copies on the device, it appends their timings to
    ``timings`` when it is handed a list."""

    name: str = "abstract"
    device: torch.device

    def put(self, value: torch.Tensor, reuse: Any = None,
            timings: Optional[list] = None) -> Any:
        raise NotImplementedError

    def get(self, handle: Any, timings: Optional[list] = None
            ) -> torch.Tensor:
        raise NotImplementedError

    def source(self, handle: Any) -> Optional[torch.Tensor]:
        """The tensor a fetch of ``handle`` copies as it is, or None where
        the tier must decode or throttle it (``get`` does)."""
        return None

    def nbytes(self, handle: Any) -> int:
        return tensor_nbytes(handle)

    def wire_nbytes(self, value: torch.Tensor) -> int:
        """Bytes a ``put(value)`` moves and occupies at rest."""
        return tensor_nbytes(value)

    def holds(self, handle: Any) -> bool:
        """Residency check: does the handle live where this tier claims?"""
        raise NotImplementedError


class DeviceBackend(MemoryBackend):
    """The pool's device memory."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.name = f"device[{device.type}]"

    def put(self, value: torch.Tensor, reuse: Any = None,
            timings: Optional[list] = None) -> torch.Tensor:
        if _reusable(reuse, value, self.device):
            return reuse.copy_(value)
        return value.detach().to(self.device, copy=True)

    def get(self, handle: torch.Tensor, timings: Optional[list] = None
            ) -> torch.Tensor:
        return handle.clone()

    def source(self, handle: torch.Tensor) -> torch.Tensor:
        return handle

    def holds(self, handle: Any) -> bool:
        return isinstance(handle, torch.Tensor) and handle.device == self.device


class HostBackend(MemoryBackend):
    """Host memory: pinned when the pool's device is CUDA. A put from the
    card copies on the transfer engine's copy stream (after the producer's
    stream) and returns once the bytes have landed, as the reference's host
    store does; fetches read the pinned buffer asynchronously."""

    def __init__(self, device: torch.device,
                 stream_for: Optional[StreamFor] = None,
                 copy: Optional[TimedCopy] = None) -> None:
        self.device = device
        self.pinned = device.type == "cuda"
        if self.pinned and stream_for is None:
            raise ValueError("a pinned host tier needs the transfer engine's "
                             "copy stream")
        self._stream_for = stream_for
        self._copy = copy
        self.name = "host[pinned]" if self.pinned else "host[cpu]"

    def put(self, value: torch.Tensor, reuse: Any = None,
            timings: Optional[list] = None) -> torch.Tensor:
        cpu = torch.device("cpu")
        if _reusable(reuse, value, cpu):
            buf = reuse
        else:
            buf = torch.empty(value.shape, dtype=value.dtype,
                              pin_memory=self.pinned)
        if value.device.type == "cuda":
            stream = self._stream_for(value.device)
            stream.wait_stream(torch.cuda.current_stream(value.device))
            with torch.cuda.stream(stream):
                if timings is None or self._copy is None:
                    buf.copy_(value, non_blocking=True)
                else:
                    self._copy(buf, value, timings)
            stream.synchronize()
        else:
            buf.copy_(value)
        return buf

    def get(self, handle: torch.Tensor, timings: Optional[list] = None
            ) -> torch.Tensor:
        if self.device.type == "cuda":
            # async from pinned memory, on the caller's current stream (the
            # transfer engine runs prefetches under its copy stream)
            if timings is None or self._copy is None:
                return handle.to(self.device, non_blocking=True)
            out = torch.empty(handle.shape, dtype=handle.dtype,
                              device=self.device)
            self._copy(out, handle, timings)
            return out
        return handle.clone()

    def source(self, handle: torch.Tensor) -> torch.Tensor:
        return handle

    def holds(self, handle: Any) -> bool:
        return (isinstance(handle, torch.Tensor) and handle.device.type == "cpu"
                and (not self.pinned or handle.is_pinned()))


class CpuTensorBackend(MemoryBackend):
    """Plain pageable CPU tensors (the ``numpy`` kind), optionally behind a
    throttle (the ``modeled`` kind). Each ``put`` sleeps out the remainder
    of ``write_latency_s + nbytes/write_bw`` past the time the real copy
    took (``get`` likewise with the read-direction numbers, after the copy
    to the device has landed). A ``None`` bandwidth with zero latency
    disables the throttle for that direction."""

    def __init__(self, device: torch.device, *,
                 read_bw: Optional[float] = None,
                 write_bw: Optional[float] = None,
                 read_latency_s: float = 0.0, write_latency_s: float = 0.0,
                 name: str = "cpu") -> None:
        self.device = device
        self.read_bw = read_bw
        self.write_bw = write_bw
        self.read_latency_s = float(read_latency_s)
        self.write_latency_s = float(write_latency_s)
        self.name = name

    @property
    def throttled(self) -> bool:
        return (self.read_bw is not None or self.write_bw is not None
                or self.read_latency_s > 0 or self.write_latency_s > 0)

    @staticmethod
    def _throttle(t0: float, nbytes: int, bw: Optional[float],
                  latency_s: float) -> None:
        if bw is None and latency_s <= 0:
            return
        want = latency_s + (nbytes / bw if bw is not None else 0.0)
        remaining = want - (time.perf_counter() - t0)
        if remaining > 0:
            time.sleep(remaining)

    def put(self, value: torch.Tensor, reuse: Any = None,
            timings: Optional[list] = None) -> torch.Tensor:
        t0 = time.perf_counter()
        cpu = torch.device("cpu")
        if _reusable(reuse, value, cpu) and not reuse.is_pinned():
            handle = reuse.copy_(value)
        else:
            handle = value.detach().to(cpu, copy=True)
        self._throttle(t0, tensor_nbytes(handle), self.write_bw,
                       self.write_latency_s)
        return handle

    def get(self, handle: torch.Tensor, timings: Optional[list] = None
            ) -> torch.Tensor:
        t0 = time.perf_counter()
        value = handle.to(self.device, copy=True)
        if self.read_bw is not None or self.read_latency_s > 0:
            if value.device.type == "cuda":
                torch.cuda.current_stream(value.device).synchronize()
            self._throttle(t0, tensor_nbytes(handle), self.read_bw,
                           self.read_latency_s)
        return value

    def holds(self, handle: Any) -> bool:
        return isinstance(handle, torch.Tensor) and handle.device.type == "cpu"


class CodecBackend(MemoryBackend):
    """A storage tier behind a KV page codec: encodes on ``put``, decodes
    on ``get``.

    The handle is an ``EncodedPage`` whose payload is stored through the
    wrapped backend, so the inner tier's character (pinned copy stream,
    modeled throttle) applies to the *encoded* bytes. The encode runs on
    the caller's current stream, after the page's producer; the inner
    put's copy then orders after it. The decode runs after the inner get's
    copy, on the same stream — under a prefetch that is the transfer
    engine's copy stream, whose event the consumer waits on. A re-put hands
    the previous handle's payload to the inner backend for reuse, so a
    pinned payload buffer is made once per entry. Spilling an
    ``EncodedPage`` into another tier of the same codec moves the payload
    as it is. ``wire_nbytes``/``nbytes`` report the encoded size."""

    def __init__(self, inner: MemoryBackend, codec: "codec_mod.KVCodec"
                 ) -> None:
        self.inner = inner
        self.codec = codec
        self.device = inner.device
        self.name = f"{codec.name}[{inner.name}]"

    def put(self, value: Any, reuse: Any = None,
            timings: Optional[list] = None) -> "codec_mod.EncodedPage":
        if isinstance(value, codec_mod.EncodedPage):
            if value.codec != self.codec.name:
                raise ValueError(
                    f"cannot move a {value.codec!r}-encoded page into a "
                    f"{self.codec.name!r} tier without decoding first")
            # spill between codec tiers: move the encoded payload only
            return dataclasses.replace(
                value, payload=self.inner.put(value.payload,
                                              timings=timings))
        payload, scale = self.codec.encode(value)
        prior = reuse.payload if isinstance(
            reuse, codec_mod.EncodedPage) else None
        return codec_mod.EncodedPage(
            codec=self.codec.name,
            payload=self.inner.put(payload, prior, timings),
            scale=scale, dtype=value.dtype, shape=tuple(value.shape),
            nbytes=self.codec.encoded_nbytes(value.shape))

    def get(self, handle: "codec_mod.EncodedPage",
            timings: Optional[list] = None) -> torch.Tensor:
        payload = self.inner.get(handle.payload, timings)
        return self.codec.decode(payload, handle.scale.to(payload.device),
                                 handle.dtype)

    def nbytes(self, handle: "codec_mod.EncodedPage") -> int:
        return int(handle.nbytes)

    def wire_nbytes(self, value: Any) -> int:
        if isinstance(value, codec_mod.EncodedPage):
            return int(value.nbytes)
        return self.codec.encoded_nbytes(value.shape)

    def holds(self, handle: Any) -> bool:
        return (isinstance(handle, codec_mod.EncodedPage)
                and self.inner.holds(handle.payload))


def backend_for(spec, device: torch.device,
                stream_for: Optional[StreamFor] = None,
                copy: Optional[TimedCopy] = None) -> MemoryBackend:
    """Storage backend for one ``TierSpec`` (duck-typed on its fields)."""
    if spec.kind == "device":
        return DeviceBackend(device)
    if spec.kind == "host":
        return HostBackend(device, stream_for, copy)
    if spec.kind == "numpy":
        return CpuTensorBackend(device, name="cpu")
    if spec.kind == "modeled":
        return CpuTensorBackend(
            device, read_bw=spec.read_bw, write_bw=spec.write_bw,
            read_latency_s=spec.read_latency_s,
            write_latency_s=spec.write_latency_s,
            name=f"modeled[{spec.name}]")
    raise ValueError(f"unknown tier kind {spec.kind!r}")
