"""Device resolution for the port's entry points."""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device that this process cannot reach
    raises instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was asked for but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain CPU path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def synced_s(dev: torch.device, fn: Callable[[], Any]) -> Tuple[Any, float]:
    """(fn(), seconds on the host clock), a CUDA device drained on both
    sides so that the seconds cover the work ``fn`` queued."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def device_of(tree) -> Optional[torch.device]:
    """Device of the first tensor found in a nested dict/list of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else tree
    for item in items:
        dev = device_of(item)
        if dev is not None:
            return dev
    return None
