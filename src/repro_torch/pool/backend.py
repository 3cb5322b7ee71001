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

Every backend stores a snapshot: ``put`` copies, and ``get`` hands back a
new tensor on the pool's device that the caller owns (callers update their
tensors in place, so neither side may alias the stored copy). A backend
that is handed the entry's previous handle (``reuse``) copies into it when
shape and type match, so re-putting one key every step allocates — and, on
the host tier, pins — its buffer once.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch

DEVICE_TIER = "device"
HOST_TIER = "host"
REMOTE_TIER = "remote"

#: gives the transfer engine's copy stream for a CUDA device
StreamFor = Callable[[torch.device], "torch.cuda.Stream"]


def tensor_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _reusable(buf: Optional[torch.Tensor], value: torch.Tensor,
              device: torch.device) -> bool:
    return (isinstance(buf, torch.Tensor) and buf.shape == value.shape
            and buf.dtype == value.dtype and buf.device == device)


class MemoryBackend:
    """One storage tier: ``put`` stores a tensor into the tier and returns
    a handle; ``get`` materializes a handle on the pool's device."""

    name: str = "abstract"
    device: torch.device

    def put(self, value: torch.Tensor, reuse: Any = None) -> Any:
        raise NotImplementedError

    def get(self, handle: Any) -> torch.Tensor:
        raise NotImplementedError

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

    def put(self, value: torch.Tensor, reuse: Any = None) -> torch.Tensor:
        if _reusable(reuse, value, self.device):
            return reuse.copy_(value)
        return value.detach().to(self.device, copy=True)

    def get(self, handle: torch.Tensor) -> torch.Tensor:
        return handle.clone()

    def holds(self, handle: Any) -> bool:
        return isinstance(handle, torch.Tensor) and handle.device == self.device


class HostBackend(MemoryBackend):
    """Host memory: pinned when the pool's device is CUDA. A put from the
    card copies on the transfer engine's copy stream (after the producer's
    stream) and returns once the bytes have landed, as the reference's host
    store does; fetches read the pinned buffer asynchronously."""

    def __init__(self, device: torch.device,
                 stream_for: Optional[StreamFor] = None) -> None:
        self.device = device
        self.pinned = device.type == "cuda"
        if self.pinned and stream_for is None:
            raise ValueError("a pinned host tier needs the transfer engine's "
                             "copy stream")
        self._stream_for = stream_for
        self.name = "host[pinned]" if self.pinned else "host[cpu]"

    def put(self, value: torch.Tensor, reuse: Any = None) -> torch.Tensor:
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
                buf.copy_(value, non_blocking=True)
            stream.synchronize()
        else:
            buf.copy_(value)
        return buf

    def get(self, handle: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cuda":
            # async from pinned memory, on the caller's current stream (the
            # transfer engine runs prefetches under its copy stream)
            return handle.to(self.device, non_blocking=True)
        return handle.clone()

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

    def put(self, value: torch.Tensor, reuse: Any = None) -> torch.Tensor:
        t0 = time.perf_counter()
        cpu = torch.device("cpu")
        if _reusable(reuse, value, cpu) and not reuse.is_pinned():
            handle = reuse.copy_(value)
        else:
            handle = value.detach().to(cpu, copy=True)
        self._throttle(t0, tensor_nbytes(handle), self.write_bw,
                       self.write_latency_s)
        return handle

    def get(self, handle: torch.Tensor) -> torch.Tensor:
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


def backend_for(spec, device: torch.device,
                stream_for: Optional[StreamFor] = None) -> MemoryBackend:
    """Storage backend for one ``TierSpec`` (duck-typed on its fields)."""
    if spec.kind == "device":
        return DeviceBackend(device)
    if spec.kind == "host":
        return HostBackend(device, stream_for)
    if spec.kind == "numpy":
        return CpuTensorBackend(device, name="cpu")
    if spec.kind == "modeled":
        return CpuTensorBackend(
            device, read_bw=spec.read_bw, write_bw=spec.write_bw,
            read_latency_s=spec.read_latency_s,
            write_latency_s=spec.write_latency_s,
            name=f"modeled[{spec.name}]")
    raise ValueError(f"unknown tier kind {spec.kind!r}")
