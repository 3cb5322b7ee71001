"""The continuous scheduler's batched decode step, captured once as a CUDA
graph and replayed every step.

The step has one shape for good: ``max_batch`` rows of one token, their
positions a (B,) device tensor (a free slot decodes token 0 at position
0), over a batch cache allocated once and written in place. Run eagerly it
is tens of small launches a layer, each issued from the interpreter; as a
graph it is one launch of the same kernels with the same arguments, so its
logits are the eager step's bit for bit.

:class:`DecodeGraph` wraps the eager step and decides each call from what
it sees, with no option:

- it captures only a step that can be replayed: every cache leaf on a
  CUDA device, ``pos`` a (B,) tensor on that device, and an eager warm-up
  that handed back the very cache leaves it was given. A host ``pos``, a
  cache off the card, or a step that writes its cache out of place stays
  eager;
- the graph is keyed on the attention path (``runtime.attention_impl``),
  the feed's shapes and types, and the data pointers of the cache's and
  the parameters' leaves. A call under another key never replays the
  graph: it captures anew, and a key found not capturable runs eager from
  then on (as does one whose capture CUDA refuses);
- the first call under a key runs the step eagerly on a side stream, which
  is that call's result, then captures it in a memory pool of the graph's
  own; each later call copies the tokens and positions into the graph's
  static buffers on the current stream and replays there, behind whatever
  that stream already waits on (the landed fetches of ``kv_offload``).

The logits returned by a replay are the graph's output buffer, valid until
the next call. The kernels' host launch counters count at call time, so
the capture's count is taken back and added again on every replay.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import ticket_buffers
from repro_torch.models import runtime

#: the device type a step is captured on
GRAPH_DEVICE = "cuda"


def _leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def capturable(leaves: List[torch.Tensor], tok: torch.Tensor, pos: Any
               ) -> bool:
    """Whether a step over the cache ``leaves`` at ``pos`` may be captured:
    every leaf, the tokens and a (B,) ``pos`` on one device of the graph's
    type."""
    if not leaves or not isinstance(pos, torch.Tensor) or pos.dim() != 1:
        return False
    dev = leaves[0].device
    return (dev.type == GRAPH_DEVICE and pos.device == dev
            and tok.device == dev and all(t.device == dev for t in leaves))


def same_leaves(a: List[torch.Tensor], b: List[torch.Tensor]) -> bool:
    """Whether ``b`` holds the very tensors' memory ``a`` does, in order."""
    return len(a) == len(b) and all(
        x.data_ptr() == y.data_ptr() for x, y in zip(a, b))


def _key(params: Any, leaves: List[torch.Tensor], tok: torch.Tensor,
         pos: torch.Tensor) -> Tuple:
    return (runtime.attention_impl(tok.device), str(tok.device),
            tuple(tok.shape), tok.dtype, tuple(pos.shape), pos.dtype,
            tuple(t.data_ptr() for t in leaves),
            tuple(t.data_ptr() for t in _leaves(params)))


def _warm_up(decode: Callable, params: Any, cache: Any, tok: torch.Tensor,
             pos: torch.Tensor):
    """The step run eagerly on a side stream, with the current stream
    ordered before and after it: (logits, cache, the side stream)."""
    main = torch.cuda.current_stream(tok.device)
    side = torch.cuda.Stream(tok.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        logits, out = decode(params, cache, tok, pos)
    main.wait_stream(side)
    logits.record_stream(main)
    return logits, out, side


def _record(decode: Callable, params: Any, cache: Any, tok: torch.Tensor,
            pos: torch.Tensor, side) -> Tuple[Any, torch.Tensor]:
    """(graph, its logits buffer): the step captured on ``side`` in a new
    memory pool. Raises if CUDA refuses the capture."""
    graph = torch.cuda.CUDAGraph()
    # the outer context puts the current stream back if the capture fails
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(),
                              stream=side,
                              capture_error_mode="thread_local"):
            logits, _ = decode(params, cache, tok, pos)
    return graph, logits


@dataclasses.dataclass
class _Captured:
    key: Tuple
    graph: Any
    tok: torch.Tensor        # static inputs, written before each replay
    pos: torch.Tensor
    logits: torch.Tensor     # the graph's output buffer
    launches: Dict[Tuple[str, Optional[str]], int]   # kernel launches a replay
    keep: List[torch.Tensor]   # buffers it reads that it does not own


class DecodeGraph:
    """``decode(params, cache, tok, pos) -> (logits, cache)``, replayed as a
    CUDA graph where the step allows it (see the module's doc). ``clock``
    counts each call as one of ``decode_captures``, ``decode_replays`` or
    ``decode_eager``."""

    def __init__(self, decode: Callable, clock: Any) -> None:
        self.decode = decode
        self._clock = clock
        self._captured: Optional[_Captured] = None
        self._eager_keys: Set[Tuple] = set()

    def __call__(self, params: Any, cache: Any, tok: torch.Tensor,
                 pos: Any) -> Tuple[torch.Tensor, Any]:
        leaves = list(_leaves(cache))
        if not capturable(leaves, tok, pos):
            return self._eager(params, cache, tok, pos)
        key = _key(params, leaves, tok, pos)
        cap = self._captured
        if cap is not None and cap.key == key:
            cap.tok.copy_(tok)
            cap.pos.copy_(pos)
            cap.graph.replay()
            ops.add_launch_counters(cap.launches)
            self._clock.decode_replays += 1
            return cap.logits, cache
        self.reset()        # a stale graph is never replayed
        if key in self._eager_keys:
            return self._eager(params, cache, tok, pos)
        return self._capture(params, cache, leaves, tok, pos, key)

    def reset(self) -> None:
        """Drop the captured graph and its memory pool."""
        self._captured = None

    def _eager(self, params, cache, tok, pos):
        self._clock.decode_eager += 1
        return self.decode(params, cache, tok, pos)

    def _capture(self, params, cache, leaves, tok, pos, key):
        tok_s, pos_s = tok.clone(), pos.clone()
        logits, out, side = _warm_up(self.decode, params, cache, tok_s, pos_s)
        if not same_leaves(leaves, list(_leaves(out))):
            self._eager_keys.add(key)
            self._clock.decode_eager += 1
            return logits, out
        before = ops.launch_counters()
        try:
            graph, g_logits = _record(self.decode, params, cache, tok_s,
                                      pos_s, side)
        except RuntimeError:
            graph = None
        # the capture ran nothing: its counts are a replay's
        after = ops.launch_counters()
        launches = {k: n - before.get(k, 0) for k, n in after.items()
                    if n != before.get(k, 0)}
        ops.add_launch_counters({k: -n for k, n in launches.items()})
        if graph is None:
            self._eager_keys.add(key)
            self._clock.decode_eager += 1
            return logits, out
        self._captured = _Captured(key, graph, tok_s, pos_s, g_logits,
                                   launches, ticket_buffers())
        self._clock.decode_captures += 1
        return logits, out
