"""Optimizer-state host offload (the counterpart of
``repro.offload.optstate``; the paper's §5.1, case 2).

AdamW's moments are touched once a step. With ``offload_opt_state`` they
live in host memory between updates (pinned when the parameters are on
CUDA) and the device never holds them whole:

- ``host_offload_state(tree)`` is the Store + Detach: every leaf copied
  into one pinned host buffer per dtype (one pinned allocation, not one a
  leaf), returned once the bytes have landed;
- ``device_fetch_state(tree, device)`` is the Prefetch of a whole tree
  (checkpointing, tests);
- ``streamed_update`` is what the train step runs instead of the
  reference's in-graph fetch and post-dispatch park: the moments of one
  (leaf, layer) slice at a time come to the device on a copy stream, one
  slice ahead of the update, and go back to the host on a second copy
  stream right after it. Three slice buffers on the device are reused
  round-robin; streams wait on events, the host never synchronizes
  between slices.

On the CPU (asked for explicitly) the host is the device: a park is a copy
into a CPU tensor and a fetch a copy out of it, so the streamed update
runs the same slice loop and gives the resident update's numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.optim.adamw import (
    Hyper, tree_items, tree_map, tree_map_with_path, update_slice,
)
from repro_torch.pool.backend import pinned_host


def _host_buffers(leaves: List[torch.Tensor], pinned: bool
                  ) -> List[torch.Tensor]:
    """One host buffer per dtype, carved into a view per leaf."""
    totals: Dict[torch.dtype, int] = {}
    for x in leaves:
        totals[x.dtype] = totals.get(x.dtype, 0) + x.numel()
    flat = {dt: torch.empty(n, dtype=dt, pin_memory=pinned)
            for dt, n in totals.items()}
    offset = {dt: 0 for dt in totals}
    views = []
    for x in leaves:
        o, n = offset[x.dtype], x.numel()
        views.append(flat[x.dtype][o:o + n].view(x.shape))
        offset[x.dtype] = o + n
    return views


def _rebuild(tree: Any, values: List[torch.Tensor]) -> Any:
    """``tree`` with its leaves, in ``tree_items`` order, replaced by
    ``values``."""
    by_path = {path: v for (path, _), v in zip(tree_items(tree), values)}
    return tree_map_with_path(lambda path, _: by_path[path], tree)


def host_offload_state(state: Any, kind: Optional[str] = None) -> Any:
    """Store + Detach: a copy of every leaf in host memory (pinned when the
    leaves are on CUDA), returned once the copies have landed."""
    leaves = [x for _, x in tree_items(state)]
    if not leaves:
        return state
    device = leaves[0].device
    views = _host_buffers(leaves, pinned_host(device, kind))
    if device.type == "cuda":
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for v, x in zip(views, leaves):
                v.copy_(x, non_blocking=True)
        stream.synchronize()
    else:
        for v, x in zip(views, leaves):
            v.copy_(x)
    return _rebuild(state, views)


def host_zeros_like(params: Any, device: torch.device,
                    kind: Optional[str] = None) -> Any:
    """fp32 zeros shaped like ``params``, made directly in host memory
    (what ``host_offload_state(adamw_init(params).mu)`` holds, without
    the device copy)."""
    leaves = [torch.empty(x.shape, dtype=torch.float32, device="meta")
              for _, x in tree_items(params)]
    views = _host_buffers(leaves, pinned_host(device, kind))
    for v in views:
        v.zero_()
    return _rebuild(params, views)


def device_fetch_state(state: Any, device: torch.device) -> Any:
    """Prefetch: a device copy of a host-parked tree."""
    return tree_map(lambda x: x.to(device), state)


@dataclasses.dataclass
class MomentCounts:
    """Moment bytes the streamed update moved, summed over its steps."""
    bytes_fetched: int = 0
    bytes_parked: int = 0


_RING = 3   # device slice buffers: one fetching, one updating, one parking


def streamed_update(work: List[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]],
                    clip: torch.Tensor, h: Hyper,
                    counts: Optional[MomentCounts] = None) -> None:
    """AdamW over ``(param, grad, mu, nu)`` slices whose moments are in
    host memory: fetch slice ``i + 1``'s moments while slice ``i`` is
    updated, park slice ``i``'s back right after. Numbers equal the
    resident update's (the same ``update_slice`` on the same values)."""
    if not work:
        return
    device = work[0][0].device
    nbytes = sum(m.numel() * m.element_size() + v.numel() * v.element_size()
                 for _, _, m, v in work)
    if counts is not None:
        counts.bytes_fetched += nbytes
        counts.bytes_parked += nbytes
    if device.type != "cuda":
        for p, g, m, v in work:
            m_dev, v_dev = m.clone(), v.clone()
            update_slice(p, g, m_dev, v_dev, clip, h)
            m.copy_(m_dev)
            v.copy_(v_dev)
        return
    for _, _, m, v in work:
        if not (m.is_pinned() and v.is_pinned()):
            raise ValueError("streamed moments must sit in pinned host "
                             "memory (host_offload_state)")
    compute = torch.cuda.current_stream(device)
    h2d, d2h = torch.cuda.Stream(device), torch.cuda.Stream(device)
    biggest = max(m.numel() for _, _, m, _ in work)
    ring = torch.empty((_RING, 2, biggest), dtype=torch.float32, device=device)
    fetched: List[Any] = [None] * len(work)
    parked: List[Any] = [None] * len(work)
    # the previous step's parks and whatever the caller queued come first
    h2d.wait_stream(compute)

    def fetch(i: int) -> None:
        _, _, m, v = work[i]
        if i >= _RING:
            h2d.wait_event(parked[i - _RING])   # its buffer is free again
        buf = ring[i % _RING]
        with torch.cuda.stream(h2d):
            m_dev = buf[0, :m.numel()].view(m.shape)
            v_dev = buf[1, :v.numel()].view(v.shape)
            m_dev.copy_(m, non_blocking=True)
            v_dev.copy_(v, non_blocking=True)
            event = torch.cuda.Event()
            event.record(h2d)
        fetched[i] = (event, m_dev, v_dev)

    fetch(0)
    for i, (p, g, m, v) in enumerate(work):
        if i + 1 < len(work):
            fetch(i + 1)
        event, m_dev, v_dev = fetched[i]
        compute.wait_event(event)
        update_slice(p, g, m_dev, v_dev, clip, h)
        done = torch.cuda.Event()
        done.record(compute)
        d2h.wait_event(done)
        with torch.cuda.stream(d2h):
            m.copy_(m_dev, non_blocking=True)
            v.copy_(v_dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(d2h)
        parked[i] = event
        fetched[i] = None
    # the moments are back on the host before anything the caller queues
    # next (and before the ring's memory is reused)
    compute.wait_event(parked[-1])
